"""gen_anim and the node drawer against the JAX package's.

The port's GIF of a 32-node Handel run, 200 ms in 10-ms frames, equals
the JAX package's frame by frame and pixel by pixel (the files are the
same bytes); the frames come from anim_frames, which hands the drawing
host arrays only; genAnim runs from the scenarios command line; the
drawer reads the port's own copy of the world map.
"""

import numpy as np
import pytest
import torch
from PIL import Image, ImageSequence

from wittgenstein_tpu.scenarios.handel_scenarios import gen_anim as jgen
from wittgenstein_tpu_torch.scenarios import handel_scenarios
from wittgenstein_tpu_torch.scenarios.handel_scenarios import anim_frames, gen_anim
from wittgenstein_tpu_torch.tools import node_drawer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _frames(path):
    with Image.open(path) as im:
        return [(np.asarray(f.convert("RGB")), f.info.get("duration"))
                for f in ImageSequence.Iterator(im)]


def test_gif_equals_the_jax_package_frame_by_frame(tmp_path):
    want, got = tmp_path / "jax.gif", tmp_path / "port.gif"
    assert jgen(32, 200, 10, str(want)) == str(want)
    assert gen_anim(32, 200, 10, str(got), device="cpu") == str(got)
    a, b = _frames(want), _frames(got)
    assert len(a) == len(b) == 20
    for i, ((fa, da), (fb, db)) in enumerate(zip(a, b)):
        assert fa.shape == fb.shape == (1112, 2000, 3), i
        assert da == db == 10, i
        assert np.array_equal(fa, fb), f"frame {i} differs"
    assert want.read_bytes() == got.read_bytes()
    # the run moves: the colors of the last frame are not the first's
    assert not np.array_equal(a[0][0], a[-1][0])


def test_anim_frames_rows():
    """Frames every 10 ms as host arrays over the live nodes; signatures
    held only grow, and a done node stays done."""
    frames = list(anim_frames(32, 60, 10, device="cpu"))
    assert [t for t, _ in frames] == [10, 20, 30, 40, 50, 60]
    prev = None
    for _, rows in frames:
        assert set(rows) == {"id", "x", "y", "val", "special"}
        assert all(isinstance(v, np.ndarray) and v.shape == (32,) for v in rows.values())
        assert rows["id"].tolist() == list(range(32))
        assert ((rows["val"] >= 1) & (rows["val"] <= 32)).all()
        if prev is not None:
            assert (rows["val"] >= prev["val"]).all()
            assert (rows["special"] >= prev["special"]).all()
        prev = rows
    assert prev["val"].sum() > 32


def test_gen_anim_command_line(tmp_path, capsys):
    out = tmp_path / "a.gif"
    handel_scenarios.main(["genAnim", "--nodes", "16", "--sim-ms", "20", "--frequency-ms",
                           "10", "--device", "cpu", "--out", str(out)])
    assert f"wrote {out}" in capsys.readouterr().out
    assert len(_frames(out)) == 2


def test_drawer_reads_the_ports_map():
    assert node_drawer.WORLD_MAP.parent.parent.name == "wittgenstein_tpu_torch"
    assert node_drawer._make_color(0) == (255, 0, 0)
    assert node_drawer._make_color(510) == (0, 255, 0)
    with Image.open(node_drawer.WORLD_MAP) as im:
        assert im.size == (2000, 1112)
