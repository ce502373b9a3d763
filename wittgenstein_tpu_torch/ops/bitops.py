"""Packed-bitset ops for the aggregation protocols.

The batched Handel state keeps per-node contribution bitsets in an
XOR-relative layout: bit j of node i's vector refers to node (i ^ j), so
level l occupies bit block [2^(l-1), 2^l) for every node, and
re-addressing a contribution from sender s's space into receiver r's
space is the bit permutation j -> j ^ (r ^ s) (`xor_shuffle`).

Words are uint32 in the JAX package.  Torch has no usable uint32
arithmetic, so the port carries every word as an int32 tensor with the
same bits.  `popcount_words`, `lowest_set_bit` and `pack_bool_words`,
and the fused-operand forms `popcount_binop`, `cand_score`,
`lowest_set_bit_andnot` and `pack_occupied`, dispatch on the tensor's
device: a CUDA tensor launches the hand-written kernel (ops/kernels.py,
sources in ops/csrc), a CPU tensor runs the plain PyTorch version below.  There is no other route
and no fallback.  Each fused form's plain version is the composition of
elementwise ops and the one-operand plain versions that its kernel
replaces.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels

WORD = 32
_M32 = 0xFFFFFFFF
_BUTTERFLY_MASKS = (0x55555555, 0x33333333, 0x0F0F0F0F, 0x00FF00FF, 0x0000FFFF)


def _check_words(words: torch.Tensor) -> None:
    if words.dtype != torch.int32:
        raise TypeError(f"packed words must be int32 bit views, got {words.dtype}")
    if words.dim() < 1:
        raise ValueError("packed words need a word axis")


def popcount_words_plain(words: torch.Tensor) -> torch.Tensor:
    """Plain version of the popcount kernel: [..., w] int32 words ->
    [...] int32 total set bits.  SWAR ladder on the unsigned value held in
    int64, so no step overflows."""
    v = words.to(torch.int64) & _M32
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = ((v * 0x01010101) & _M32) >> 24
    return v.sum(dim=-1).to(torch.int32)


def lowest_set_bit_plain(words: torch.Tensor) -> torch.Tensor:
    """Plain version of the lowest-set-bit kernel: [..., w] int32 words ->
    [...] int32 index of the lowest set bit; 32 for an all-zero row (the
    first word is taken and (0 & -0) - 1 has 32 bits set), the same as
    the JAX package's lax path."""
    nz = (words != 0).to(torch.uint8)
    widx = torch.argmax(nz, dim=-1)  # first nonzero word; 0 if none
    wval = torch.gather(words, -1, widx[..., None]).to(torch.int64) & _M32
    low = ((wval & ((-wval) & _M32)) - 1) & _M32
    return (widx.to(torch.int32) * WORD + popcount_words_plain(low.to(torch.int32)))


def _combine(a: torch.Tensor, b: torch.Tensor, op: str) -> torch.Tensor:
    if op == "and":
        return a & b
    if op == "or":
        return a | b
    if op == "andnot":
        return a & ~b
    raise ValueError(f"op {op!r} not in ('and', 'or', 'andnot')")


def popcount_binop_plain(a: torch.Tensor, b: torch.Tensor, op: str) -> torch.Tensor:
    """Plain version of the binop kernel: popcount_words_plain(a op b)."""
    return popcount_words_plain(_combine(a, b, op))


def cand_score_plain(sig, inc, ind, agg=None):
    """Plain version of the candidate-score kernel, as Handel's score sites
    compose it.  sig [..., K, w] candidate rows; inc, ind, agg [..., w]
    node rows broadcast over K.  Returns [..., K] int32:
    s = sizeIfIncluded = |(sig ∩ inc ≠ ∅ ? sig : sig ∪ inc) ∪ ind|,
    card = |sig|, wind = |sig ∪ ind|, aggi = [sig ∩ agg ≠ ∅] as 0/1
    (None without agg)."""
    inc, ind = inc[..., None, :], ind[..., None, :]
    inter = popcount_words_plain(sig & inc) > 0
    cc = torch.where(inter[..., None], sig, sig | inc)
    s = popcount_words_plain(cc | ind)
    card = popcount_words_plain(sig)
    wind = popcount_words_plain(sig | ind)
    aggi = None
    if agg is not None:
        aggi = (popcount_words_plain(sig & agg[..., None, :]) > 0).to(torch.int32)
    return s, card, wind, aggi


def lowest_set_bit_andnot_plain(a: torch.Tensor, b: torch.Tensor):
    """Plain version of the andnot kernel: (has, lowest) of e = a & ~b,
    has = popcount_words_plain(e) > 0, lowest = lowest_set_bit_plain(e)."""
    e = a & ~b
    return popcount_words_plain(e) > 0, lowest_set_bit_plain(e)


def pack_bool_words_plain(bits: torch.Tensor) -> torch.Tensor:
    """Plain version of the pack kernel: [..., W] bool -> [..., ceil(W/32)]
    int32 words, bit j of word k = element 32k + j, padding bits 0.  The
    weighted sum runs in int64 so bit 31 does not overflow, then keeps the
    low 32 bits as an int32 bit view."""
    w = bits.shape[-1]
    pad = (-w) % WORD
    if pad:
        bits = torch.cat([bits, bits.new_zeros(bits.shape[:-1] + (pad,))], dim=-1)
    grouped = bits.reshape(bits.shape[:-1] + ((w + pad) // WORD, WORD))
    weights = torch.ones(WORD, dtype=torch.int64, device=bits.device) << torch.arange(
        WORD, dtype=torch.int64, device=bits.device
    )
    v = (grouped.to(torch.int64) * weights).sum(-1)
    return (v - ((v >> 31) << 32)).to(torch.int32)


def pack_bool_words(bits: torch.Tensor) -> torch.Tensor:
    """Pack bools over the last axis into int32 words: [..., W] bool ->
    [..., ceil(W/32)] (the engine's wheel-occupancy summary; pairs with
    popcount_words and lowest_set_bit)."""
    if bits.dtype != torch.bool:
        raise TypeError(f"pack_bool_words takes bool, got {bits.dtype}")
    if bits.dim() < 1:
        raise ValueError("pack_bool_words needs a bit axis")
    if bits.is_cuda:
        return kernels.pack_bool_words(bits)
    if bits.device.type != "cpu":
        raise RuntimeError(f"no pack_bool_words for device {bits.device}")
    return pack_bool_words_plain(bits)


def pack_occupied_plain(fill: torch.Tensor, shift: int) -> torch.Tensor:
    """Plain version of the occupancy kernel: the wheel sites' composition,
    [..., W] int32 fill -> [..., ceil(W/32)] int32 words of the row rotated
    left by shift (mod W) and tested > 0."""
    return pack_bool_words_plain(torch.roll(fill > 0, -(shift % fill.shape[-1]), -1))


def _route(name: str, *xs) -> bool:
    """True for CUDA operands (launch the kernel), False for CPU ones (run
    the plain version); any other device raises."""
    for x in xs:
        if x is not None:
            _check_words(x)
    if any(x is not None and x.is_cuda for x in xs):
        return True
    for x in xs:
        if x is not None and x.device.type != "cpu":
            raise RuntimeError(f"no {name} for device {x.device}")
    return False


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    """Total set bits over the last axis of packed int32 words."""
    if _route("popcount_words", words):
        return kernels.popcount_words(words)
    return popcount_words_plain(words)


def lowest_set_bit(words: torch.Tensor) -> torch.Tensor:
    """Index of the lowest set bit over the last axis of packed [..., w]
    int32 words (32 for an all-zero row — gate on popcount > 0)."""
    if _route("lowest_set_bit", words):
        return kernels.lowest_set_bit(words)
    return lowest_set_bit_plain(words)


def popcount_binop(a: torch.Tensor, b: torch.Tensor, op: str) -> torch.Tensor:
    """popcount_words(a op b) for op in "and", "or", "andnot" (a & ~b),
    with a and b broadcast over their leading axes; on the card a op b is
    never formed."""
    if _route("popcount_binop", a, b):
        return kernels.popcount_binop(a, b, op)
    return popcount_binop_plain(a, b, op)


def cand_score(sig, inc, ind, agg=None):
    """Handel's candidate score (s, card, wind, aggi) of each candidate row
    of sig [..., K, w] against its node rows inc, ind, agg [..., w]; see
    cand_score_plain.  One pass over sig on the card."""
    if _route("cand_score", sig, inc, ind, agg):
        return kernels.cand_score(sig, inc, ind, agg)
    return cand_score_plain(sig, inc, ind, agg)


def lowest_set_bit_andnot(a: torch.Tensor, b: torch.Tensor):
    """(has, lowest) of each row of a & ~b: has [...] bool (any bit set),
    lowest [...] int32 (32 for an empty row)."""
    if _route("lowest_set_bit_andnot", a, b):
        return kernels.lowest_set_bit_andnot(a, b)
    return lowest_set_bit_andnot_plain(a, b)


def pack_occupied(fill: torch.Tensor, shift: int) -> torch.Tensor:
    """The wheel's occupancy words: pack_bool_words(roll(fill > 0, -shift,
    -1)) of an int32 [..., W] fill, shift a host int; on the card one pass
    over the fill, read in place."""
    if _route("pack_occupied", fill):
        return kernels.pack_occupied(fill, shift)
    return pack_occupied_plain(fill, shift)


def xor_shuffle(words: torch.Tensor, v) -> torch.Tensor:
    """Permute bit positions j -> j ^ v of packed vectors.

    words: [..., W] int32; v: int or a [...] integer tensor of xor values
    in [0, 32 W).  The word-level part gathers word index ^ (v >> 5); the
    bit-level part applies 5 conditional butterfly stages for v & 31.
    Shifts of the int32 words are arithmetic in torch, so each right
    shift is masked down to the bits a logical shift would keep."""
    w = words.shape[-1]
    if not isinstance(v, torch.Tensor):
        v = torch.tensor(int(v), dtype=torch.int32, device=words.device)
    v = v.to(torch.int64)
    v_hi = v >> 5
    v_lo = v & 31
    idx = torch.arange(w, dtype=torch.int64, device=words.device)
    gather_idx = (idx ^ v_hi[..., None]).expand(words.shape)
    x = torch.gather(words, -1, gather_idx)
    for b in range(5):
        m = _BUTTERFLY_MASKS[b]
        sh = 1 << b
        # the masks' top `sh` bits are clear, so `>>` then `& m` drops
        # exactly the sign-extended bits
        swapped = ((x & m) << sh) | ((x >> sh) & m)
        bit = ((v_lo >> b) & 1) == 1
        x = torch.where(bit[..., None], swapped, x)
    return x


def block_mask(start: int, end: int, n_words: int) -> np.ndarray:
    """Static mask with bits [start, end) set, as packed uint32 words."""
    bits = ((1 << end) - 1) ^ ((1 << start) - 1)
    out = np.zeros(n_words, dtype=np.uint32)
    for w in range(n_words):
        out[w] = (bits >> (32 * w)) & 0xFFFFFFFF
    return out


def level_block_mask(level: int, n_words: int) -> np.ndarray:
    """Mask of level `level`'s block in the XOR layout: bit 0 for level 0,
    bits [2^(l-1), 2^l) for level l >= 1."""
    if level == 0:
        return block_mask(0, 1, n_words)
    return block_mask(1 << (level - 1), 1 << level, n_words)
