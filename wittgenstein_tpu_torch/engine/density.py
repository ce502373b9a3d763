"""Narrow storage dtypes for carried state, int32 compute.

Carried `SimState` integers that fit a narrower dtype are stored narrow:
the engine's message-lane columns (`msg_from/msg_to/msg_type` and their
overflow twins, per `lane_plan`) and protocol leaves declared in
`BatchedProtocol.NARROW_LEAVES`.  Compute stays int32: the engine widens
lanes at the delivery-view gather and protocols widen declared leaves at
hook entry (`widen_tree`) and re-narrow at exit (`narrow_tree`), so every
kernel body computes on int32 and narrowing is bit-identical by
construction.  The port keeps the JAX package's plan exactly, so the two
carry the same dtypes leaf for leaf.

Sentinel mapping: leaves that use INT32_MAX as "empty" (Handel's
`cand_rank`) store the narrow dtype's own max instead; widen/narrow map
the two losslessly, so that max is reserved.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

INT32_MAX = 2**31 - 1

# lanes never narrow below int16 (int8 ids would cap N at 127)
_LANE_DTYPES = (np.int16, np.int32)
_LEAF_DTYPES = (np.int8, np.int16, np.int32)

TORCH_DTYPES = {
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
}


def narrowest_int(max_value: int, *, reserve_sentinel: bool = False,
                  candidates=_LEAF_DTYPES) -> np.dtype:
    """Narrowest signed dtype whose range holds [0, max_value] (plus the
    reserved sentinel slot when asked)."""
    for dt in candidates:
        hi = np.iinfo(dt).max - (1 if reserve_sentinel else 0)
        if max_value <= hi:
            return np.dtype(dt)
    raise ValueError(f"max_value {max_value} does not fit int32")


@dataclasses.dataclass(frozen=True)
class LanePlan:
    """Storage dtypes for the engine's message-lane columns."""

    idx: torch.dtype  # msg_from / msg_to / ovf_from / ovf_to
    mtype: torch.dtype  # msg_type / ovf_type


def lane_plan(n_nodes: int, n_msg_types: int) -> LanePlan:
    """The engine's dtype plan for one (N, mtype-count) config (the JAX
    package's default, narrow plan)."""
    idx = narrowest_int(max(0, n_nodes - 1), candidates=_LANE_DTYPES)
    mtype = narrowest_int(max(0, n_msg_types - 1))
    return LanePlan(TORCH_DTYPES[idx.name], TORCH_DTYPES[mtype.name])


@dataclasses.dataclass(frozen=True)
class NarrowLeaf:
    """One protocol leaf's narrowing declaration: carried at `dtype`, every
    non-sentinel value in [0, declared_max] given the protocol's static
    geometry."""

    name: str
    dtype: str  # "int8" | "int16"
    declared_max: int
    sentinel: bool = False  # INT32_MAX <-> iinfo(dtype).max mapping


def narrow_leaf(x: torch.Tensor, spec: NarrowLeaf) -> torch.Tensor:
    """int32 -> declared storage dtype (sentinel-mapped)."""
    dt = TORCH_DTYPES[spec.dtype]
    y = x.to(dt)
    if spec.sentinel:
        y = torch.where(x == INT32_MAX, torch.iinfo(dt).max, y).to(dt)
    return y


def widen_leaf(x: torch.Tensor, spec: NarrowLeaf) -> torch.Tensor:
    """Declared storage dtype -> int32 compute (sentinel-mapped)."""
    y = x.to(torch.int32)
    if spec.sentinel:
        y = torch.where(x == torch.iinfo(TORCH_DTYPES[spec.dtype]).max, INT32_MAX, y)
    return y


def narrow_tree(proto: dict, specs) -> dict:
    """Re-narrow declared leaves of a proto dict (absent leaves are
    skipped; everything else passes through)."""
    if not specs:
        return proto
    out = dict(proto)
    for spec in specs:
        if spec.name in out:
            out[spec.name] = narrow_leaf(out[spec.name], spec)
    return out


def widen_tree(proto: dict, specs) -> dict:
    """Widen declared leaves of a proto dict to int32 compute."""
    if not specs:
        return proto
    out = dict(proto)
    for spec in specs:
        if spec.name in out:
            out[spec.name] = widen_leaf(out[spec.name], spec)
    return out
