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
- `layout=` and `shard_replicas` place states on a device mesh, which
  waits for the multi-device slice (ROADMAP Queue A 16, mesh2d): they
  raise.

The statistics are the JAX package's five, reduced on the state's
device: `done_min`, `done_max`, `done_avg`, `msg_rcv_avg` and
`all_done`, as 0-d tensors of its dtypes.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Tuple

import torch

from ..engine.core import INT_MAX
from ..profiling.xla_cost import compiled_cost_summary, record_call
from ..runtime.locks import make_lock, yield_point
from ..runtime.supervisor import iter_leaves

_MESH_ITEM = "the multi-device slice (ROADMAP Queue A 16: mesh2d)"


def shard_replicas(states, mesh, axis: str = "replicas"):
    """Place a stacked state on a device mesh, sharded along `axis`:
    waits for mesh2d."""
    raise NotImplementedError(f"shard_replicas needs a device mesh, {_MESH_ITEM}")


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


class _CachedRun:
    """The cached entry for one (net.cache_key(), sim_ms): a callable that
    runs `net.run_ms_batched(states, sim_ms)` and reduces the statistics,
    and that registers one program per input geometry."""

    def __init__(self, net, sim_ms: int, key: tuple):
        self.key = key
        self.net = net
        self.protocol = type(net.protocol).__name__
        self.sim_ms = int(sim_ms)
        self._programs: "OrderedDict[tuple, bool]" = OrderedDict()
        self._summaries: "OrderedDict[tuple, dict]" = OrderedDict()
        # two threads calling with one new geometry must register ONE
        # program: double-checked locking, as the JAX package's compile
        self._compile_lock = make_lock("runcache.compile")

    @staticmethod
    def _signature(states) -> tuple:
        return tuple(
            (tuple(getattr(leaf, "shape", ())), str(getattr(leaf, "dtype", "?")),
             str(getattr(leaf, "device", "?")))
            for _, leaf, _ in iter_leaves(states)
        )

    def __call__(self, states):
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
        return out, _run_stats(out)

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
    """The cached entry for (net.cache_key(), sim_ms): calls with an
    equivalent network hit it."""
    if layout is not None:
        raise NotImplementedError(f"a run-cache layout needs a device mesh, {_MESH_ITEM}")
    key = (net.cache_key(), int(sim_ms), None)
    with _CACHE_LOCK:
        fn = _RUN_CACHE.get(key)
        if fn is not None:
            _COUNTERS["hits"] += 1
            _RUN_CACHE.move_to_end(key)
            return fn
        _COUNTERS["misses"] += 1
        fn = _CachedRun(net, sim_ms, key)
        _RUN_CACHE[key] = fn
        while len(_RUN_CACHE) > _RUN_CACHE_MAX:
            _RUN_CACHE.popitem(last=False)
            _COUNTERS["evictions"] += 1
        return fn


def sharded_run_stats(net, states, sim_ms: int, layout=None) -> Tuple[object, dict]:
    """Run the batched simulation `sim_ms` ms through the run cache and
    reduce the statistics on the device.  Returns (final states, dict of
    0-d tensors)."""
    return _run_and_reduce(net, sim_ms, layout=layout)(states)
