"""Carry simulation state between the JAX package and the port.

`state_from_numpy` takes the JAX package's SimState (a NamedTuple with a
`proto` dict) whose leaves were turned into numpy arrays — e.g.
`jax.tree_util.tree_map(np.asarray, state)` — and returns the port's
SimState on `device`: the same leaf names and shapes, uint32 words as
int32 bit views, every other leaf in its own dtype.  `state_to_numpy`
does the reverse, giving back uint32 for the leaves the JAX package
carries as words.  Which leaves those are is the protocol's to say: each
batched protocol lists them in `WORD_LEAVES` (a name may be a
protocol's word in one protocol and a count in another, as `agg` is in
Handel and SanFermin).  Slush, Snowflake, P2PFlood,
OptimisticP2PSignature, SanFerminCappos and ENRGossiping carry only bool
and int32 leaves (ENR's per-replica clock `last_t` among them), so they
declare no `WORD_LEAVES` (nor `PROTO_KEYS`), as PingPong, Dfinity, Casper
and Paxos do not.  With the two, both packages can start from one
state and be compared leaf by leaf.

A fault side-car (`faults`, the JAX package's FaultState as numpy leaves,
or a mapping of them) comes across as the port's FaultState and goes back
as a dict of numpy leaves, and a telemetry side-car (`tele`, the JAX
package's TelemetryState) as the port's TelemetryState, the same way.  ETHPoW's state, which has no proto and no
message store, crosses too: a tree whose fields are EthPowState's (the
JAX package's dataclass, a NamedTuple or a mapping) becomes the port's
EthPowState, and `state_to_numpy` of an EthPowState gives the dict of its
leaves.  This module imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from .engine.core import SimState
from .faults.state import FaultState
from .telemetry.state import TelemetryState

SIDE_CARS = {"faults": FaultState, "tele": TelemetryState}


def ported_protocols() -> tuple:
    """The port's batched protocol classes (imported here, not at module
    load: they import the engine, as this module does)."""
    from .protocols.avalanche_batched import BatchedAvalanche
    from .protocols.casper_batched import BatchedCasper
    from .protocols.dfinity_batched import BatchedDfinity
    from .protocols.enr_batched import BatchedENR
    from .protocols.gsf_batched import BatchedGSF
    from .protocols.handel_batched import BatchedHandel
    from .protocols.handeleth2_batched import BatchedHandelEth2
    from .protocols.optimistic_p2p_signature_batched import BatchedOptimisticP2PSignature
    from .protocols.p2pflood_batched import BatchedP2PFlood
    from .protocols.p2phandel_batched import BatchedP2PHandel
    from .protocols.paxos_batched import BatchedPaxos
    from .protocols.pingpong_batched import BatchedPingPong
    from .protocols.sanfermin_batched import BatchedSanFermin
    from .protocols.sanfermin_cappos_batched import BatchedSanFerminCappos

    return (BatchedHandel, BatchedGSF, BatchedP2PHandel, BatchedPingPong, BatchedDfinity,
            BatchedHandelEth2, BatchedSanFermin, BatchedCasper, BatchedPaxos,
            BatchedAvalanche, BatchedP2PFlood, BatchedOptimisticP2PSignature,
            BatchedSanFerminCappos, BatchedENR)


def protocol_of(proto_keys):
    """The ported protocol class whose PROTO_KEYS all appear among a
    state's proto keys, or None: a protocol without word leaves declares
    no PROTO_KEYS, and its leaves, like those of a protocol of no ported
    class, are all taken as non-words."""
    keys = set(proto_keys)
    hits = [c for c in ported_protocols() if c.PROTO_KEYS and set(c.PROTO_KEYS) <= keys]
    if len(hits) > 1:
        raise ValueError(f"proto keys match several protocols: {[c.__name__ for c in hits]}")
    return hits[0] if hits else None


def is_word_leaf(protocol, name: str) -> bool:
    """Whether `protocol` (a batched protocol class or instance) carries
    proto leaf `name` as uint32 words; a WORD_LEAVES entry ending in "*"
    names a prefix."""
    for w in protocol.WORD_LEAVES if protocol is not None else ():
        if name == w or (w.endswith("*") and name.startswith(w[:-1])):
            return True
    return False


def _fields(tree) -> Mapping[str, Any]:
    if isinstance(tree, Mapping):
        return tree
    if hasattr(tree, "_asdict"):
        return tree._asdict()
    if dataclasses.is_dataclass(tree):
        return {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}
    raise TypeError(f"expected a SimState-like NamedTuple or a mapping, got {type(tree)}")


def _to_tensor(a, device) -> torch.Tensor:
    a = np.array(a, order="C")  # a copy; 0-d leaves (a single replica's clock) stay 0-d
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype.kind == "u":
        raise TypeError(f"unsupported unsigned leaf dtype {a.dtype}")
    return torch.from_numpy(a).to(device)


def state_from_numpy(tree, device) -> SimState:
    """The JAX package's state, as numpy leaves, as the port's SimState (or
    EthPowState)."""
    from .protocols.ethpow_batched import EthPowState

    fields = _fields(tree)
    if set(fields) == set(EthPowState._fields):
        return EthPowState(**{f: _to_tensor(fields[f], device) for f in EthPowState._fields})
    missing = set(SimState._fields) - set(fields)
    if missing:
        raise ValueError(f"state is missing fields {sorted(missing)}")
    out = {}
    for f in SimState._fields:
        v = fields[f]
        if f == "proto":
            out[f] = {k: _to_tensor(a, device) for k, a in _fields(v).items()}
        elif f in SIDE_CARS:
            if v is None or (isinstance(v, tuple) and not v):
                out[f] = ()
            else:
                fv, cls = _fields(v), SIDE_CARS[f]
                out[f] = cls(*[_to_tensor(fv[k], device) for k in cls._fields])
        else:
            out[f] = _to_tensor(v, device)
    return SimState(**out)


def _to_numpy(t: torch.Tensor, word: bool) -> np.ndarray:
    a = t.detach().cpu().numpy()
    if word and a.dtype != np.int32:
        raise TypeError(f"a word leaf must be an int32 bit view, got {a.dtype}")
    return a.view(np.uint32) if word else a


def state_to_numpy(state: SimState) -> dict:
    """The port's SimState as a dict of numpy leaves in the JAX package's
    dtypes (proto as a nested dict; empty side-cars stay ()).  The word
    leaves are those of the ported protocol the proto's keys identify
    (`protocol_of`); a state of no such protocol has none.  An EthPowState
    gives the dict of its leaves; a placed state (parallel.mesh2d) that of
    its gathered state."""
    from .parallel.mesh2d import PlacedState
    from .protocols.ethpow_batched import EthPowState

    if isinstance(state, PlacedState):
        state = state.gather()

    if isinstance(state, EthPowState):
        return {f: _to_numpy(v, False) for f, v in state._asdict().items()}
    protocol = protocol_of(state.proto)
    out = {}
    for f in SimState._fields:
        v = getattr(state, f)
        if f == "proto":
            out[f] = {k: _to_numpy(a, is_word_leaf(protocol, k)) for k, a in v.items()}
        elif isinstance(v, (FaultState, TelemetryState)):
            out[f] = {k: _to_numpy(a, False) for k, a in v._asdict().items()}
        elif isinstance(v, torch.Tensor):
            out[f] = _to_numpy(v, False)
        else:
            out[f] = v
    return out
