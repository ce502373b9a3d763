"""Device-memory footprint model: replicas per card from the state's own
leaves.

The model walks the real `init_state()` tree, side-cars included, so a
state-layout change (a new side-car, a wider channel) moves the number
by itself.  Each leaf is named by the path string the JAX package gives
its twin (`jax.tree_util.keystr`: `.msg_arrival`, `.proto['pong']`,
`.faults.crash_at`), and the word leaves count as uint32, the JAX
package's dtype for them (the port holds them as int32 bit views of the
same size).

Model, not measurement: a run's true peak adds the eager temporaries of
a tick on top of the live state.  `replicas_per_chip()` takes an
`overhead` factor for them (default 2.0x: one extra live copy of the
state), and `hbm_report(memory=...)` sets the model beside a measured
footprint.  The card's memory is read from the device
(`torch.cuda.get_device_properties(dev).total_memory`) unless `hbm_gib`
is given.
"""

from __future__ import annotations

import re
from typing import Optional

import torch

from ..runtime.supervisor import _dtype_name, iter_keyed_leaves

DEFAULT_STATE_OVERHEAD = 2.0

_KEY = re.compile(r"(GetAttrKey|DictKey|SequenceKey|FlattenedIndexKey)\((?:name|key|idx)=(.*)\)")


def _keystr(keys: tuple) -> str:
    """A rendered key path as `jax.tree_util.keystr` renders it."""
    out = []
    for k in keys:
        kind, arg = _KEY.fullmatch(k).groups()
        out.append(f".{arg[1:-1]}" if kind == "GetAttrKey" else f"[{arg}]")
    return "".join(out)


def state_bytes_per_replica(state) -> dict:
    """Total bytes of one replica's state tree and the top contributors:
    {"total_bytes", "n_leaves", "top": [(path, bytes, dtype)],
    "by_dtype": {dtype: bytes}}.

    `state` must be UNREPLICATED (no leading replica axis): pass the
    init_state() result, not replicate_state()'s.  Tensors and numpy
    arrays are sized alike."""
    sizes = []
    by_dtype: dict = {}
    total = 0
    for keys, leaf, word in iter_keyed_leaves(state):
        if isinstance(leaf, torch.Tensor):
            nb = leaf.numel() * leaf.element_size()
        else:
            dt = getattr(leaf, "dtype", None)
            nb = int(getattr(leaf, "size", 0)) * int(getattr(dt, "itemsize", 0) or 0)
        dname = _dtype_name(leaf, word) if hasattr(leaf, "dtype") else "none"
        total += nb
        by_dtype[dname] = by_dtype.get(dname, 0) + nb
        sizes.append((_keystr(keys), nb, dname))
    sizes.sort(key=lambda kv: -kv[1])
    return {
        "total_bytes": total,
        "n_leaves": len(sizes),
        "top": sizes[:8],
        "by_dtype": dict(sorted(by_dtype.items(), key=lambda kv: -kv[1])),
    }


def _device_gib(state) -> float:
    """The memory of the card the state lies on, in GiB."""
    dev = next((leaf.device for _, leaf, _ in iter_keyed_leaves(state)
                if isinstance(leaf, torch.Tensor)), None)
    if dev is None or dev.type != "cuda":
        raise ValueError("the state lies on no card: pass hbm_gib")
    return torch.cuda.get_device_properties(dev).total_memory / (1 << 30)


def replicas_per_chip(
    state,
    hbm_gib: Optional[float] = None,
    overhead: float = DEFAULT_STATE_OVERHEAD,
    reserved_gib: float = 0.5,
) -> dict:
    """Memory-bounded replica count for one card: floor((memory -
    reserved) / (bytes_per_replica * overhead)).  `hbm_gib` defaults to
    the memory of the card the state lies on; `reserved_gib` covers the
    CUDA context and the kernels' libraries."""
    if hbm_gib is None:
        hbm_gib = _device_gib(state)
    per = state_bytes_per_replica(state)
    usable = max(0.0, (hbm_gib - reserved_gib)) * (1 << 30)
    denom = per["total_bytes"] * max(1.0, overhead)
    return {
        "bytes_per_replica": per["total_bytes"],
        "mib_per_replica": round(per["total_bytes"] / (1 << 20), 1),
        "hbm_gib": hbm_gib,
        "reserved_gib": reserved_gib,
        "overhead_factor": overhead,
        "replicas": int(usable // denom) if denom else 0,
    }


def hbm_report(
    state,
    memory: Optional[dict] = None,
    hbm_gib: Optional[float] = None,
) -> dict:
    """The BUDGET.json "hbm" block: the leaf model and, when a measured
    footprint of ONE replica of this state is given (`memory`, with
    `live_bytes` and, where known, `argument_size_in_bytes`,
    `output_size_in_bytes` and `temp_size_in_bytes`), the model against
    it."""
    density = replicas_per_chip(state, hbm_gib=hbm_gib)
    per = state_bytes_per_replica(state)
    out = {
        "model": density,
        "top_leaves": [
            {"path": p, "bytes": b, "dtype": d} for p, b, d in per["top"]
        ],
        "bytes_by_dtype": per["by_dtype"],
    }
    if memory:
        live = memory.get("live_bytes", 0)
        arg_b = memory.get("argument_size_in_bytes", 0)
        out_b = memory.get("output_size_in_bytes", 0)
        temp_b = memory.get("temp_size_in_bytes", 0)
        modeled = density["bytes_per_replica"] * density["overhead_factor"]
        state_shaped = arg_b + out_b
        out["measured"] = {
            "argument_bytes": arg_b,
            "output_bytes": out_b,
            "temp_bytes": temp_b,
            "temp_share_of_live": (
                round(temp_b / live, 3) if live else None
            ),
            "live_bytes_1_replica": live,
            "modeled_bytes": int(modeled),
            "model_over_state_bytes": (
                round(modeled / state_shaped, 2) if state_shaped else None
            ),
            "model_over_measured": (
                round(modeled / live, 2) if live else None
            ),
            "note": (
                "replicas_per_chip is fed by the MODEL"
                " (bytes_per_replica * overhead_factor), never by these"
                " measured numbers; model_over_measured < 1 means the"
                " measured footprint exceeds the overhead headroom"
            ),
        }
    return out
