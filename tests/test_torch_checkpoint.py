"""The port's checkpoints: round trips, resume, integrity, and the JAX package's file format.

Saved and loaded, a state comes back equal in every leaf — on the flat
store (P2PFlood) and the wheel (PingPong), with the fault and the
telemetry side-cars, and ETHPoW's own state — and a run resumed from a
checkpoint at tick t equals the uninterrupted run.  A flipped byte is a
`CheckpointCorruptError` naming the leaf, a side-car mismatch a
`CheckpointLayoutError`; `CheckpointManager.restore_latest` walks past a
corrupt file and retention keeps `keep` files.  The file is the JAX
package's: a Handel checkpoint the JAX package wrote loads into the port
and resumes equal to the JAX package's uninterrupted run, and one the
port wrote loads through the JAX package's `load_state`.
"""

import dataclasses
import os
import zipfile

import jax
import numpy as np
import pytest
import torch

from test_torch_paxos import assert_same_state, jax_numpy
from wittgenstein_tpu.core.registries import registry_batched_protocols as jreg
from wittgenstein_tpu.engine import checkpoint as jck
from wittgenstein_tpu.engine.core import replicate_state as jreplicate
from wittgenstein_tpu.protocols import ethpow_batched as jeth
from wittgenstein_tpu.protocols.ethpow import ETHPoWParameters as JEthParams
from wittgenstein_tpu_torch.core.registries import registry_batched_protocols as treg
from wittgenstein_tpu_torch.engine import checkpoint as tck
from wittgenstein_tpu_torch.engine import replicate_state
from wittgenstein_tpu_torch.faults import FaultConfig, FaultPlan
from wittgenstein_tpu_torch.interop import state_to_numpy
from wittgenstein_tpu_torch.protocols import ethpow_batched as teth
from wittgenstein_tpu_torch.protocols.ethpow import ETHPoWParameters as TEthParams
from wittgenstein_tpu_torch.protocols.p2pflood_batched import make_p2pflood
from wittgenstein_tpu_torch.protocols.pingpong_batched import make_pingpong
from wittgenstein_tpu_torch.telemetry import TelemetryConfig

TELE = TelemetryConfig(snapshots=8, snapshot_every_ms=10)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _same(a, b, tag=""):
    """Two numpy state trees (state_to_numpy) equal leaf for leaf."""
    assert set(a) == set(b), tag
    for k, v in a.items():
        if isinstance(v, dict):
            _same(v, b[k], f"{tag}{k}.")
        elif isinstance(v, np.ndarray):
            assert v.dtype == b[k].dtype and v.shape == b[k].shape, tag + k
            assert np.array_equal(v, b[k]), tag + k
        else:
            assert v == b[k], tag + k


def _plan(n):
    return (FaultPlan("mix").crash(list(range(3, n, 9)), at=20, recover=70)
            .drop(100, start=0).inflate(1500, start=0).silence([5], start=10))


def _build(case):
    """(net, replicated state) for a round-trip case, on the CPU."""
    if case == "flat":
        net, st = make_p2pflood(capacity=2048, device="cpu")
        return net, replicate_state(st, 2)
    if case == "wheel":
        net, st = make_pingpong(64, device="cpu")
        return net, replicate_state(st, 2)
    if case == "wheel_tele":
        net, st = make_pingpong(64, telemetry=TELE, device="cpu")
        return net, replicate_state(st, 2)
    if case == "flat_faults":
        net, st = make_p2pflood(capacity=2048, device="cpu")
        return net.with_faults(replicate_state(st, 2), FaultConfig(), _plan(net.n_nodes))
    net, st = make_pingpong(64, telemetry=TELE, device="cpu")
    return net.with_faults(replicate_state(st, 2), FaultConfig(), _plan(64))


CASES = ("flat", "wheel", "wheel_tele", "flat_faults", "wheel_tele_faults")


@pytest.mark.parametrize("case", CASES)
def test_round_trip_and_resume(tmp_path, case):
    net, s0 = _build(case)
    s1 = net.run_ms_batched(s0, 100)
    path = str(tmp_path / "s.npz")
    manifest = tck.save_state(s1, path, meta={"run_id": "r-1", "tick": 100})
    assert manifest["layout"] == tck.ENGINE_LAYOUT == "timewheel-v3"
    assert manifest["sidecars"] == {
        "tele": "TelemetryState" if "tele" in case else None,
        "faults": "FaultState" if "faults" in case else None}
    assert tck.manifest_trace(tck.read_manifest(path)) == {"run_id": "r-1"}
    back = tck.load_state(s0, path)
    _same(state_to_numpy(back), state_to_numpy(s1))
    assert all(t.device.type == "cpu" for t in back.proto.values())
    resumed = net.run_ms_batched(back, 100)
    straight = net.run_ms_batched(s1, 100)
    _same(state_to_numpy(resumed), state_to_numpy(straight))
    assert not [n for n in os.listdir(tmp_path) if ".tmp." in n]


def test_ethpow_round_trip_and_jax_keys(tmp_path):
    tsim = teth.BatchedEthPow(TEthParams(number_of_miners=4), device="cpu")
    ts = tsim.run_ms(teth.replicate_ethpow(tsim.init_state(), 2), 30_000)
    path = str(tmp_path / "e.npz")
    tck.save_state(ts, path)
    template = teth.replicate_ethpow(tsim.init_state(), 2)
    _same(state_to_numpy(tck.load_state(template, path)), state_to_numpy(ts))
    # the JAX package's dataclass flattens to index keys, and its file loads
    jsim = jeth.BatchedEthPow(JEthParams(number_of_miners=4))
    jstate = jsim.init_state()
    jpath = str(tmp_path / "j.npz")
    jck.save_state(jstate, jpath)
    with np.load(path) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)
    got = tck.load_state(tsim.init_state(), jpath)
    want = {f.name: np.asarray(getattr(jstate, f.name))
            for f in dataclasses.fields(jstate)}
    _same(state_to_numpy(got), want)


def _flip_member_byte(path, member):
    with zipfile.ZipFile(path) as z:
        info = z.getinfo(member + ".npy")
    with open(path, "r+b") as f:
        f.seek(info.header_offset + 26)
        name_len, extra_len = np.frombuffer(f.read(4), np.uint16)
        at = info.header_offset + 30 + int(name_len) + int(extra_len) + info.compress_size // 2
        f.seek(at)
        b = f.read(1)
        f.seek(at)
        f.write(bytes([b[0] ^ 0x40]))


def test_corruption_and_layout_errors(tmp_path):
    net, s0 = _build("flat_faults")
    path = str(tmp_path / "s.npz")
    tck.save_state(s0, path)
    bad = str(tmp_path / "flipped.npz")
    with open(path, "rb") as f, open(bad, "wb") as g:
        g.write(f.read())
    _flip_member_byte(bad, "msg_arrival")
    with pytest.raises(tck.CheckpointCorruptError, match="msg_arrival"):
        tck.load_state(s0, bad)
    # a leaf rewritten under the old manifest fails its crc32, named
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    arrays["done_at"] = arrays["done_at"] + 1
    tampered = str(tmp_path / "tampered.npz")
    np.savez_compressed(tampered, **arrays)
    with pytest.raises(tck.CheckpointCorruptError, match="'done_at' failed its integrity"):
        tck.load_state(s0, tampered)
    tck.load_state(s0, tampered, verify=False)
    # saved with faults, loaded without: refused before any leaf
    plain = make_p2pflood(capacity=2048, device="cpu")[1]
    with pytest.raises(tck.CheckpointLayoutError, match="side-car mismatch on 'faults'"):
        tck.load_state(replicate_state(plain, 2), path)
    arrays = dict(arrays, **{tck.LAYOUT_KEY: np.asarray("flatring-v0")})
    old = str(tmp_path / "old.npz")
    np.savez_compressed(old, **arrays)
    with pytest.raises(tck.CheckpointLayoutError, match="flatring-v0"):
        tck.load_state(s0, old)
    (tmp_path / "junk.npz").write_bytes(b"not a zip")
    with pytest.raises(tck.CheckpointCorruptError, match="unreadable"):
        tck.read_manifest(str(tmp_path / "junk.npz"))
    small = replicate_state(plain, 1)
    with pytest.raises(tck.CheckpointShapeError):
        tck.load_state(net.with_faults(small, FaultConfig())[1], path)


def test_manager_retention_and_walk_back(tmp_path):
    net, s0 = _build("wheel")
    mgr = tck.CheckpointManager(str(tmp_path / "ck"), keep=3)
    states = [s0]
    for step in range(1, 6):
        states.append(net.run_ms_batched(states[-1], 20))
        mgr.save(states[-1], step, meta={"step": step})
    assert mgr.steps() == [3, 4, 5] and mgr.latest_step() == 5
    _flip_member_byte(mgr.path_for(5), "time")
    state, step, manifest = mgr.restore_latest(s0)
    assert step == 4 and manifest["meta"] == {"step": 4}
    _same(state_to_numpy(state), state_to_numpy(states[4]))
    os.remove(os.path.join(mgr.directory, tck.LATEST_NAME))
    assert mgr.latest_step() == 5
    with pytest.raises(ValueError):
        tck.CheckpointManager(str(tmp_path / "x"), keep=0)
    assert tck.CheckpointManager(str(tmp_path / "empty")).restore_latest(s0) is None


def test_handel_checkpoint_crosses_packages(tmp_path):
    jnet, jst = jreg.get("handel").factory()
    js0 = jreplicate(jst, 2)
    js1 = jnet.run_ms_batched(js0, 40)
    js2 = jnet.run_ms_batched(js1, 40)
    jpath = str(tmp_path / "jax.npz")
    jck.save_state(js1, jpath)
    tnet, tst = treg.get("handel").factory(device="cpu")
    ts0 = replicate_state(tst, 2)
    # the JAX package's checkpoint resumes in the port
    resumed = tnet.run_ms_batched(tck.load_state(ts0, jpath), 40)
    assert_same_state(jax_numpy(js2), state_to_numpy(resumed), "jax -> port resume")
    # the port's checkpoint loads through the JAX package's load_state
    ts1 = tnet.run_ms_batched(ts0, 40)
    tpath = str(tmp_path / "port.npz")
    tck.save_state(ts1, tpath)
    loaded = jck.load_state(js0, tpath)
    assert_same_state(jax_numpy(js1), jax_numpy(loaded), "port -> jax load")
    with np.load(jpath) as a, np.load(tpath) as b:
        assert a.files == b.files
    assert jax.tree_util.tree_structure(loaded) == jax.tree_util.tree_structure(js1)
