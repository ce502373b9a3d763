"""Counter-based RNG for the batched engine.

The reference derives per-destination latency jitter from a single random
seed and the destination id via an xorshift hash (Network.getPseudoRandom,
Network.java:493-503); the batched engine keeps that hash, vectorized, and
derives per-event seeds from (replica_seed, time, stream, counter) with a
murmur3 finalizer.

Torch has no usable uint32 arithmetic (shifts, adds and multiplies raise
"not implemented for 'UInt32'"), so every function here computes on int64
holding the uint32 value in [0, 2^32) and masks after each step; results
come back as int32, bit for bit what the JAX package's uint32/int32 code
gives.  Parts may be Python ints or integer tensors and broadcast together.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _u32(x):
    """An int or integer tensor as its uint32 value (int64 tensor / int)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & M32
    return int(x) & M32


def _mul32(x, c: int):
    """(x * c) mod 2^32 for x in [0, 2^32) without leaving int64: split c
    into 16-bit halves so no partial product reaches 2^63."""
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & M32


def to_i32(x):
    """uint32 value held in int64 -> int32 tensor with the same bits."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def pseudo_delta(dest_id, seed):
    """Deterministic delta in [0, 99] from (destId, seed) — bit-exact
    vectorization of Network.getPseudoRandom (Network.java:493-503)."""
    a = _u32(dest_id)
    a = a ^ ((a << 13) & M32)
    a = a ^ (a >> 17)  # logical: a holds the unsigned value
    a = a ^ ((a << 5) & M32)
    x = a ^ _u32(seed)
    x = x - ((x >> 31) << 32)  # back to the signed int32 value
    # lax.rem truncates toward zero, like torch.fmod
    return torch.abs(torch.fmod(x, 100)).to(torch.int32)


def _mix32(x):
    """murmur3 fmix32 avalanche on uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


# the hash's state before its first part
HASH32_START = _GOLDEN


def hash32_absorb(h, *parts):
    """The hash's state after absorbing `parts` into state `h` (a uint32
    value, int or int64 tensor): hash32_u(*parts) is
    hash32_absorb(HASH32_START, *parts), so a prefix of parts shared by
    several hashes is absorbed once."""
    for p in parts:
        p = _u32(p)
        h = _mix32(h ^ ((p + _GOLDEN + ((h << 6) & M32) + (h >> 2)) & M32))
    return h


def hash32_u(*parts):
    """hash32 as its uint32 value in an int64 tensor."""
    h = hash32_absorb(HASH32_START, *parts)
    if not isinstance(h, torch.Tensor):
        h = torch.tensor(h, dtype=torch.int64)
    return h


def hash32(*parts):
    """Combine integer parts into one well-mixed int32 (the batched stand-in
    for `rd.nextInt()` seeds; order-sensitive, collision-resistant)."""
    return to_i32(hash32_u(*parts))


def uniform_u01(*parts):
    """Deterministic float32 uniform in [0, 1) from integer parts."""
    return u01(hash32_u(*parts))


def u01(h: torch.Tensor) -> torch.Tensor:
    """uniform_u01 of a hash's uint32 value."""
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))
