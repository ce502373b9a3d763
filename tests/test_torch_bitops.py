"""The port's packed-bitset ops against the JAX package.

`popcount_words`, `lowest_set_bit`, `pack_bool_words` and `xor_shuffle`
of wittgenstein_tpu_torch run here as their plain PyTorch versions (CPU
tensors) and must equal the JAX package's lax twins bit for bit, and its
Pallas kernels run in interpret mode (as tests/test_bitops_pallas.py runs
them).  Words are int32 bit views on the port's side, uint32 on JAX's.
The CUDA kernels themselves are held against these plain versions on the
card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wittgenstein_tpu.ops import bitops as jbits
from wittgenstein_tpu.ops.bitops_pallas import (
    lowest_set_bit_pallas,
    pack_bool_words_pallas,
    popcount_words_pallas,
)
from wittgenstein_tpu_torch.ops import bitops as tbits
from wittgenstein_tpu_torch.ops import kernels

# tests/test_bitops_pallas.py's odd shapes, plus 3-D batches
WORD_SHAPES = [
    (1, 1),
    (3, 2),
    (5, 4),
    (7, 3),
    (2, 7),
    (4, 64),
    (129, 5),
    (3, 2, 9),
    (2, 3, 5),
    (4, 2, 64),
    (2, 8, 128),
]
FILLS = ["random", "zeros", "ones", "top_bit", "sparse"]
# pack_bool_words: bit axes around the word size and the wheel's 512 rows,
# under 1-D, 2-D and 3-D operands
BIT_WIDTHS = [1, 31, 32, 33, 64, 100, 512]
BIT_LEADS = [(), (5,), (3, 4)]
BIT_FILLS = ["random", "false", "true"]


def _words(shape, fill, seed):
    rng = np.random.RandomState(seed)
    if fill == "random":
        w = rng.randint(0, 1 << 32, size=shape, dtype=np.uint32)
    elif fill == "zeros":
        w = np.zeros(shape, np.uint32)
    elif fill == "ones":
        w = np.full(shape, 0xFFFFFFFF, np.uint32)
    elif fill == "top_bit":  # negative as int32
        w = np.full(shape, 0x80000000, np.uint32)
    else:  # mostly-zero rows with a few random bits: deep lowest bits
        w = rng.randint(0, 1 << 32, size=shape, dtype=np.uint32)
        w = np.where(rng.rand(*shape) < 0.1, w & (1 << rng.randint(0, 32, shape)), 0)
        w = w.astype(np.uint32)
    return w


def _port(w: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(w.view(np.int32).copy())


@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("shape", WORD_SHAPES, ids=str)
def test_popcount_and_lowest_match_lax(shape, fill):
    w = _words(shape, fill, seed=sum(shape))
    got_pc = tbits.popcount_words(_port(w)).numpy()
    want_pc = np.asarray(jbits._popcount_words_lax(jnp.asarray(w)))
    assert got_pc.dtype == want_pc.dtype == np.int32
    assert np.array_equal(got_pc, want_pc)
    got_lo = tbits.lowest_set_bit(_port(w)).numpy()
    want_lo = np.asarray(jbits._lowest_set_bit_lax(jnp.asarray(w)))
    assert got_lo.dtype == want_lo.dtype == np.int32
    assert np.array_equal(got_lo, want_lo)
    if fill == "zeros":
        assert (got_lo == 32).all()  # the empty-row convention


@pytest.mark.parametrize(
    "shape,fill",
    [((7, 3), "random"), ((129, 5), "sparse"), ((3, 2, 9), "zeros"),
     ((4, 64), "ones"), ((2, 7), "top_bit")],
    ids=str,
)
def test_plain_versions_match_pallas_interpret(shape, fill):
    w = _words(shape, fill, seed=len(shape) + shape[-1])
    assert np.array_equal(
        tbits.popcount_words_plain(_port(w)).numpy(),
        np.asarray(popcount_words_pallas(jnp.asarray(w), lane_pad=False)),
    )
    assert np.array_equal(
        tbits.lowest_set_bit_plain(_port(w)).numpy(),
        np.asarray(lowest_set_bit_pallas(jnp.asarray(w), lane_pad=False)),
    )


def _bits(shape, fill, seed):
    if fill == "false":
        return np.zeros(shape, bool)
    if fill == "true":
        return np.ones(shape, bool)
    return np.random.RandomState(seed).rand(*shape) < 0.5


@pytest.mark.parametrize("fill", BIT_FILLS)
@pytest.mark.parametrize("lead", BIT_LEADS, ids=str)
@pytest.mark.parametrize("width", BIT_WIDTHS)
def test_pack_bool_words_matches_lax(width, lead, fill):
    b = _bits(lead + (width,), fill, seed=width + len(lead))
    got = tbits.pack_bool_words(torch.from_numpy(b))
    assert got.dtype == torch.int32 and got.shape == lead + ((width + 31) // 32,)
    want = np.asarray(jbits._pack_bool_words_lax(jnp.asarray(b)))
    assert np.array_equal(got.numpy().view(np.uint32), want)
    # round trip: bit j of word k is element 32k + j, padding bits zero
    words = got.numpy().view(np.uint32)
    unpacked = (words[..., :, None] >> np.arange(32, dtype=np.uint32)) & 1
    flat = unpacked.reshape(lead + (-1,)).astype(bool)
    assert np.array_equal(flat[..., :width], b) and not flat[..., width:].any()


@pytest.mark.parametrize(
    "shape,fill",
    [((1,), "true"), ((7, 33), "random"), ((4, 512), "random"), ((2, 3, 100), "true"),
     ((3, 64), "false")],
    ids=str,
)
def test_pack_plain_matches_pallas_interpret(shape, fill):
    b = _bits(shape, fill, seed=shape[-1])
    assert np.array_equal(
        tbits.pack_bool_words_plain(torch.from_numpy(b)).numpy().view(np.uint32),
        np.asarray(pack_bool_words_pallas(jnp.asarray(b), lane_pad=False)),
    )


@pytest.mark.parametrize("n_words", [1, 2, 4, 64, 128])
def test_xor_shuffle_matches_jax(n_words):
    rng = np.random.RandomState(n_words)
    w = rng.randint(0, 1 << 32, size=(37, n_words), dtype=np.uint32)
    v = rng.randint(0, 32 * n_words, size=37).astype(np.int32)
    got = tbits.xor_shuffle(_port(w), torch.from_numpy(v)).numpy().view(np.uint32)
    want = np.asarray(jbits.xor_shuffle(jnp.asarray(w), jnp.asarray(v)))
    assert np.array_equal(got, want)
    # scalar v, and a batched [.., W] operand with a [..] xor batch
    vs = int(v[0])
    assert np.array_equal(
        tbits.xor_shuffle(_port(w), vs).numpy().view(np.uint32),
        np.asarray(jbits.xor_shuffle(jnp.asarray(w), vs)),
    )
    w3 = w.reshape(1, 37, n_words).repeat(2, 0)
    v3 = np.stack([v, v[::-1]])
    assert np.array_equal(
        tbits.xor_shuffle(_port(w3), torch.from_numpy(v3)).numpy().view(np.uint32),
        np.asarray(jbits.xor_shuffle(jnp.asarray(w3), jnp.asarray(v3))),
    )


def test_block_masks_match():
    for n_words in (1, 4, 128):
        for level in range(0, 13):
            if (1 << level) > 32 * n_words:
                break
            assert np.array_equal(
                tbits.level_block_mask(level, n_words),
                jbits.level_block_mask(level, n_words),
            )
    assert np.array_equal(tbits.block_mask(3, 70, 4), jbits.block_mask(3, 70, 4))


def test_dispatch_is_by_device_without_fallback():
    w = _port(_words((5, 4), "random", 1))
    before = {k.name: k.launches for k in kernels.KERNELS}
    # a CPU tensor takes the plain version and launches nothing
    assert torch.equal(tbits.popcount_words(w), tbits.popcount_words_plain(w))
    assert torch.equal(tbits.lowest_set_bit(w), tbits.lowest_set_bit_plain(w))
    assert {k.name: k.launches for k in kernels.KERNELS} == before
    # the kernel wrappers refuse a CPU tensor instead of falling back
    with pytest.raises(RuntimeError):
        kernels.popcount_words(w)
    with pytest.raises(RuntimeError):
        kernels.lowest_set_bit(w)
    bits = torch.from_numpy(_bits((5, 40), "random", 2))
    assert torch.equal(tbits.pack_bool_words(bits), tbits.pack_bool_words_plain(bits))
    assert {k.name: k.launches for k in kernels.KERNELS} == before
    with pytest.raises(RuntimeError):
        kernels.pack_bool_words(bits)
    # pack takes bools only
    with pytest.raises(TypeError):
        tbits.pack_bool_words(bits.to(torch.int32))
    # words must be int32 bit views
    with pytest.raises(TypeError):
        tbits.popcount_words(w.to(torch.int64))
    # no other device has a route
    with pytest.raises(RuntimeError):
        tbits.popcount_words(torch.empty((3, 2), dtype=torch.int32, device="meta"))
