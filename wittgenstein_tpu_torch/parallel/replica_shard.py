"""The run cache: one cached entry per (network, horizon), one program
per input geometry, and the run statistics reduced on the device.

The JAX package's replica_shard compiles each (net.cache_key(), sim_ms)
run once per input geometry and reduces done/traffic statistics inside
the same program; the batch scheduler, the fault sweep and the search
driver dispatch through it, and its monotonic counters are how "one
program per family" and "generations 2..G are pure cache hits" are
shown.  The port runs eagerly, so it keeps the cache's shape and its
counters with these design differences:

- a **program** is the first call of an entry at a new input leaf
  signature (every leaf's shape, dtype and device).  It is counted
  under the JAX package's name `compiles`, so "one program per family"
  reads the same in both packages, and registered under the entry's
  double-checked lock as the JAX package's compile is;
- nothing is compiled, so `compile_seconds_total` stays 0.0;
- the JAX package's durable compile store has no counterpart, so
  `store_hits` and `store_puts` stay 0;
- a program's summary holds `replicas` and the cost and memory of its
  first call (profiling.xla_cost: wall seconds, hand-written kernel
  launches, the allocator's statistics on a card), where the JAX
  package's holds its compiled program's XLA cost and memory analyses;
- with a `layout=` (a mesh2d.MeshLayout) an entry places every call's
  states on that layout and runs the placed state, one engine loop per
  mesh cell; the layout's geometry is the key's third slot, as in the
  JAX package's `_run_and_reduce`, so a fresh layout of one geometry
  hits the entry and (2, 4) and (4, 2) are two entries.  A program's
  signature is then the layout's geometry and every cell's leaves.

The statistics are the JAX package's five: `done_min`, `done_max`,
`done_avg`, `msg_rcv_avg` and `all_done`, as 0-d tensors of its dtypes.
On one device they are reduced there; on a placed state each cell
reduces its own rows and nodes to integer partials (counts and sums,
min, max, all), the partials are combined on the first cell's device,
and the two means divide the combined integer totals once, so they
equal the unsharded run's bit for bit.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Tuple

import torch

from ..engine.core import INT_MAX
from ..profiling.xla_cost import compiled_cost_summary, record_call
from ..runtime.locks import make_lock, yield_point
from ..runtime.supervisor import iter_leaves
from . import exchange
from .mesh2d import MeshLayout, PlacedState


def shard_replicas(states, mesh, axis: str = "replicas"):
    """Place a stacked state with leading replica axis onto the mesh,
    split along `axis` (a layout without a node axis)."""
    return MeshLayout(mesh, replica_axis=axis, node_axis=None).place(None, states)


# the cache, keyed EXPLICITLY on (net.cache_key(), sim_ms, layout) instead
# of hashing the network object; bounded, a hit moves its entry to the
# back, the oldest entry goes first.  A cached entry holds its engine
# (and the tables it carries): clear_run_cache releases them
_RUN_CACHE: "OrderedDict[tuple, _CachedRun]" = OrderedDict()
_RUN_CACHE_MAX = 64
# entry creation is check-then-act; concurrent callers (scheduler lanes,
# sweep threads) must not each install their own _CachedRun for one key
_CACHE_LOCK = make_lock("runcache.entry")

# recheck the program table AFTER taking the entry's lock; module-level
# so a test can revert it and show the interleaving that duplicates a
# program without it
_RECHECK_UNDER_LOCK = True

# monotonic across clear_run_cache(): Prometheus counters never step back
_COUNTERS = {
    "hits": 0,
    "misses": 0,
    "evictions": 0,
    "compiles": 0,
    "compile_seconds_total": 0.0,
    "store_hits": 0,
    "store_puts": 0,
}


def _run_stats(out) -> dict:
    """The JAX package's five run statistics over the live nodes, on the
    state's device (int32 sums, float32 means, as XLA computes them)."""
    live = ~out.down
    done = torch.where(live, out.done_at, 0)
    n_live = torch.clamp(live.sum(dtype=torch.int32), min=1).to(torch.float32)
    rcv = torch.where(live, out.msg_received, 0).sum(dtype=torch.int32)
    return {
        "done_min": torch.where(live, out.done_at, INT_MAX).min(),
        "done_max": done.max(),
        "done_avg": done.sum(dtype=torch.int32).to(torch.float32) / n_live,
        "msg_rcv_avg": rcv.to(torch.float32) / n_live,
        "all_done": torch.where(live, out.done_at > 0, True).all(),
    }


def _placed_stats(out: PlacedState) -> dict:
    """_run_stats of a placed state: each cell's integer partials over
    its rows and nodes (live count, done sum, received sum, done min and
    max, all done), combined on the first cell's device, the means
    divided once."""
    parts = []
    for row in out.cells:
        for c in row:
            live = ~c.down
            done = torch.where(live, c.done_at, 0)
            parts.append(torch.stack([
                live.sum(dtype=torch.int32),
                done.sum(dtype=torch.int32),
                torch.where(live, c.msg_received, 0).sum(dtype=torch.int32),
                torch.where(live, c.done_at, INT_MAX).min(),
                done.max(),
                torch.where(live, c.done_at > 0, True).all().to(torch.int32),
            ]))
    p = exchange.gather_to([x[None] for x in parts], out.layout.cell_device(0, 0))
    n_live = torch.clamp(p[:, 0].sum(dtype=torch.int32), min=1).to(torch.float32)
    return {
        "done_min": p[:, 3].min(),
        "done_max": p[:, 4].max(),
        "done_avg": p[:, 1].sum(dtype=torch.int32).to(torch.float32) / n_live,
        "msg_rcv_avg": p[:, 2].sum(dtype=torch.int32).to(torch.float32) / n_live,
        "all_done": p[:, 5].all(),
    }


class _CachedRun:
    """The cached entry for one (net.cache_key(), sim_ms, layout
    geometry): a callable that runs `net.run_ms_batched(states, sim_ms)`
    — on `layout`'s placement of the states when there is one — and
    reduces the statistics, and that registers one program per input
    geometry."""

    def __init__(self, net, sim_ms: int, key: tuple, layout=None):
        self.key = key
        self.net = net
        self.layout = layout
        self.protocol = type(net.protocol).__name__
        self.sim_ms = int(sim_ms)
        self._programs: "OrderedDict[tuple, bool]" = OrderedDict()
        self._summaries: "OrderedDict[tuple, dict]" = OrderedDict()
        # two threads calling with one new geometry must register ONE
        # program: double-checked locking, as the JAX package's compile
        self._compile_lock = make_lock("runcache.compile")

    @staticmethod
    def _signature(states) -> tuple:
        if isinstance(states, PlacedState):
            return (states.layout.geometry(),) + tuple(
                _CachedRun._signature(c) for row in states.cells for c in row)
        return tuple(
            (tuple(getattr(leaf, "shape", ())), str(getattr(leaf, "dtype", "?")),
             str(getattr(leaf, "device", "?")))
            for _, leaf, _ in iter_leaves(states)
        )

    def __call__(self, states):
        if self.layout is not None:
            states = self.layout.place(self.net, states)
        sig = self._signature(states)
        first = False
        if sig not in self._programs:
            # the race window: between this unlocked miss and the locked
            # recheck another thread can register the same program
            yield_point("runcache.lookup-miss")
            with self._compile_lock:
                known = _RECHECK_UNDER_LOCK and sig in self._programs
                if not known:
                    yield_point("runcache.compile")
                    _COUNTERS["compiles"] += 1
                    self._summaries[sig] = {
                        "replicas": next((s[0][0] for s in sig if s[0]), None)
                    }
                    self._programs[sig] = True
                    first = True
        if first:
            # a program's summary: the cost and memory of its first call
            out, rec = record_call(self.net.run_ms_batched, states, self.sim_ms,
                                   device=self.net.device)
            self._summaries[sig].update(compiled_cost_summary(rec))
        else:
            out = self.net.run_ms_batched(states, self.sim_ms)
        return out, (_placed_stats(out) if isinstance(out, PlacedState) else _run_stats(out))

    def summaries(self) -> list:
        return list(self._summaries.values())


def clear_run_cache() -> None:
    """Drop every cached entry (the counters survive: they are
    monotonic)."""
    _RUN_CACHE.clear()


def run_cache_info() -> dict:
    return {"size": len(_RUN_CACHE), "maxsize": _RUN_CACHE_MAX, **_COUNTERS}


def run_cache_metrics() -> dict:
    """The export view: counters plus each entry's program summaries."""
    return {
        **_COUNTERS,
        "size": len(_RUN_CACHE),
        "maxsize": _RUN_CACHE_MAX,
        "entries": [
            {
                "protocol": entry.protocol,
                "sim_ms": entry.sim_ms,
                "programs": entry.summaries(),
            }
            for entry in _RUN_CACHE.values()
        ],
    }


def _run_and_reduce(net, sim_ms: int, layout=None):
    """The cached entry for (net.cache_key(), sim_ms, layout geometry):
    calls with an equivalent network and layout hit it."""
    key = (net.cache_key(), int(sim_ms), layout.geometry() if layout is not None else None)
    with _CACHE_LOCK:
        fn = _RUN_CACHE.get(key)
        if fn is not None:
            _COUNTERS["hits"] += 1
            _RUN_CACHE.move_to_end(key)
            return fn
        _COUNTERS["misses"] += 1
        fn = _CachedRun(net, sim_ms, key, layout=layout)
        _RUN_CACHE[key] = fn
        while len(_RUN_CACHE) > _RUN_CACHE_MAX:
            _RUN_CACHE.popitem(last=False)
            _COUNTERS["evictions"] += 1
        return fn


def sharded_run_stats(net, states, sim_ms: int, layout=None) -> Tuple[object, dict]:
    """Run the batched simulation `sim_ms` ms through the run cache and
    reduce the statistics on the device.  Without a layout the states run
    where they are (a placed state on its own layout); with a
    mesh2d.MeshLayout the entry places them on it first.  Returns (final
    states, dict of 0-d tensors)."""
    return _run_and_reduce(net, sim_ms, layout=layout)(states)
