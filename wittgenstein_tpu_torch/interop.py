"""Carry simulation state between the JAX package and the port.

`state_from_numpy` takes the JAX package's SimState (a NamedTuple with a
`proto` dict) whose leaves were turned into numpy arrays — e.g.
`jax.tree_util.tree_map(np.asarray, state)` — and returns the port's
SimState on `device`: the same leaf names and shapes, uint32 words as
int32 bit views, every other leaf in its own dtype.  `state_to_numpy`
does the reverse, giving back uint32 for the leaves the JAX package
carries as words.  With the two, both packages can start from one state
and be compared leaf by leaf.  This module imports nothing of JAX.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .engine.core import SimState

# proto leaves the JAX package carries as uint32 words (the bitset
# aggregation protocols' vectors and channel/candidate content); a leaf of
# one of these names that is not int32 in the port (P2PHandel's bool
# ver_sig) keeps its own dtype
WORD_LEAVES = ("agg", "ind", "inc", "ver_sig", "bl", "byz", "ver", "indiv", "ind_seen",
               "pend_ind")
WORD_LEAF_PREFIXES = ("in_sig", "cand_sig")


def is_word_leaf(name: str) -> bool:
    return name in WORD_LEAVES or name.startswith(WORD_LEAF_PREFIXES)


def _fields(tree) -> Mapping[str, Any]:
    if isinstance(tree, Mapping):
        return tree
    if hasattr(tree, "_asdict"):
        return tree._asdict()
    raise TypeError(f"expected a SimState-like NamedTuple or a mapping, got {type(tree)}")


def _to_tensor(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype.kind == "u":
        raise TypeError(f"unsupported unsigned leaf dtype {a.dtype}")
    return torch.from_numpy(a.copy()).to(device)


def state_from_numpy(tree, device) -> SimState:
    """The JAX package's state, as numpy leaves, as the port's SimState."""
    fields = _fields(tree)
    missing = set(SimState._fields) - set(fields)
    if missing:
        raise ValueError(f"state is missing fields {sorted(missing)}")
    out = {}
    for f in SimState._fields:
        v = fields[f]
        if f == "proto":
            out[f] = {k: _to_tensor(a, device) for k, a in _fields(v).items()}
        elif f in ("tele", "faults"):
            if v not in ((), None):
                raise NotImplementedError(f"the port carries no {f} side-car")
            out[f] = ()
        else:
            out[f] = _to_tensor(v, device)
    return SimState(**out)


def _to_numpy(t: torch.Tensor, word: bool) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a.view(np.uint32) if word and a.dtype == np.int32 else a


def state_to_numpy(state: SimState) -> dict:
    """The port's SimState as a dict of numpy leaves in the JAX package's
    dtypes (proto as a nested dict; empty side-cars stay ())."""
    out = {}
    for f in SimState._fields:
        v = getattr(state, f)
        if f == "proto":
            out[f] = {k: _to_numpy(a, is_word_leaf(k)) for k, a in v.items()}
        elif isinstance(v, torch.Tensor):
            out[f] = _to_numpy(v, False)
        else:
            out[f] = v
    return out
