"""The port's fused wheel-occupancy form `pack_occupied` on the CPU.

`pack_occupied(fill, shift)` replaces, at the engine's two occupancy sites
(`_wheel_next_arrival` and `pending_messages`), the composition
`pack_bool_words(torch.roll(fill > 0, -shift, -1))` over the int32 wheel
fill.  Here, on CPU tensors, its plain version must equal (1) that torch
composition and (2) the JAX package's own composition, its lax pack of
`fill[(shift + arange(W)) % W] > 0`, on the same numpy fill, bit for bit,
over ragged and word-multiple widths, shifts across the wrap and beyond
W, fills with negative values (the test is `> 0`, not `!= 0`) and
strided fills.  A routing test runs CPU PingPong on the wheel and spies on
the engine's form: both sites must call it.  The CUDA kernel itself is
held against this plain version on the card by chip_smoke.py.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wittgenstein_tpu.ops import bitops as jbits
from wittgenstein_tpu_torch.engine import core as tcore
from wittgenstein_tpu_torch.engine import replicate_state
from wittgenstein_tpu_torch.ops import bitops as tbits
from wittgenstein_tpu_torch.ops import kernels
from wittgenstein_tpu_torch.protocols.pingpong_batched import make_pingpong

WIDTHS = [1, 31, 32, 33, 100, 128, 512]
FILLS = ["zeros", "sparse", "dense", "all_positive", "negative"]
LEADS = [(), (1,), (5,), (2, 3), "transposed"]


def _shifts(w: int) -> list:
    return [0, 1, 31, 32, w - 1, w, 3 * w + 5]


def _fill(shape, kind: str, seed: int) -> np.ndarray:
    """An int32 wheel fill: per-row entry counts, or signed values."""
    rng = np.random.RandomState(seed)
    if kind == "zeros":
        return np.zeros(shape, np.int32)
    if kind == "all_positive":
        return rng.randint(1, 2**31 - 1, shape).astype(np.int32)
    counts = rng.randint(1, 5, shape)
    if kind == "sparse":  # a few occupied rows, as the wheel usually is
        return np.where(rng.rand(*shape) < 0.05, counts, 0).astype(np.int32)
    if kind == "dense":
        return np.where(rng.rand(*shape) < 0.7, counts, 0).astype(np.int32)
    # negative values, zeros and positives side by side, INT_MIN included
    v = rng.randint(-5, 3, shape).astype(np.int32)
    v.reshape(-1)[::7] = np.iinfo(np.int32).min
    return v


def _torch_fill(fill: np.ndarray, lead) -> torch.Tensor:
    if lead == "transposed":  # [3, W] with strides (1, 3)
        return torch.from_numpy(np.ascontiguousarray(fill.T)).t()
    return torch.from_numpy(fill.copy())


def _lax_pack(fill: np.ndarray, shift: int) -> np.ndarray:
    """The JAX package's composition: lax pack of the rotated `> 0` test."""
    w = fill.shape[-1]
    rotated = fill[..., (shift + np.arange(w)) % w] > 0
    return np.asarray(jbits._pack_bool_words_lax(jnp.asarray(rotated))).astype(np.uint32)


@pytest.mark.parametrize("lead", LEADS, ids=str)
@pytest.mark.parametrize("kind", FILLS)
@pytest.mark.parametrize("w", WIDTHS)
def test_pack_occupied_matches_composition_and_lax(w, kind, lead):
    shape = (3, w) if lead == "transposed" else lead + (w,)
    fill = _fill(shape, kind, seed=w * 7 + FILLS.index(kind))
    t = _torch_fill(fill, lead)
    assert lead != "transposed" or w == 1 or not t.is_contiguous()
    for shift in _shifts(w):
        got = tbits.pack_occupied(t, shift)
        composed = tbits.pack_bool_words_plain(torch.roll(t > 0, -shift, -1))
        assert got.dtype == torch.int32 and got.shape == shape[:-1] + ((w + 31) // 32,)
        assert torch.equal(got, composed), shift
        assert torch.equal(got, tbits.pack_occupied_plain(t, shift)), shift
        assert np.array_equal(got.numpy().view(np.uint32), _lax_pack(fill, shift)), shift


def test_pack_occupied_dispatch_is_by_device_without_fallback():
    fill = torch.from_numpy(_fill((5, 40), "negative", 1))
    before = {k.name: k.launches for k in kernels.KERNELS}
    # a CPU tensor takes the plain version and launches nothing
    assert torch.equal(tbits.pack_occupied(fill, 7), tbits.pack_occupied_plain(fill, 7))
    assert {k.name: k.launches for k in kernels.KERNELS} == before
    # the kernel wrapper refuses a CPU tensor instead of falling back
    with pytest.raises(RuntimeError):
        kernels.pack_occupied(fill, 7)
    # the fill is int32 counts
    with pytest.raises(TypeError):
        tbits.pack_occupied(fill.to(torch.int64), 7)
    with pytest.raises(TypeError):
        tbits.pack_occupied(fill > 0, 7)
    # no other device has a route
    with pytest.raises(RuntimeError):
        tbits.pack_occupied(torch.empty((3, 40), dtype=torch.int32, device="meta"), 0)
    assert kernels.PACK_OCCUPIED in kernels.KERNELS
    assert kernels.PACK_OCCUPIED.library is kernels.PACK_LIB


def test_wheel_sites_call_pack_occupied(monkeypatch):
    """CPU PingPong on the 512-row wheel with stop_when_done: the
    next-arrival scan and the quiescence count both go through the form,
    with the rotation shifts the jump loop asks for."""
    seen = {}
    real = tcore.pack_occupied

    def spy(fill, shift):
        caller = sys._getframe(1).f_code.co_name
        seen.setdefault(caller, set()).add(shift)
        return real(fill, shift)

    monkeypatch.setattr(tcore, "pack_occupied", spy)
    net, state = make_pingpong(64, device="cpu")
    assert not net.flat and net.wheel_rows == 512
    net.run_ms_batched(replicate_state(state, 2), 300, stop_when_done=True)
    assert set(seen) == {"_wheel_next_arrival", "pending_messages"}, seen
    assert seen["pending_messages"] == {0}
    assert len(seen["_wheel_next_arrival"]) > 1
    assert all(0 <= s < net.wheel_rows for s in seen["_wheel_next_arrival"])
