"""Stats framework.

Reference semantics: core utils/StatsHelper.java — Stat/SimpleStats
value objects, getStatsOn over node getters, StatsGetter plugin interface,
and field-by-field integer-average across runs (StatsHelper.avg uses Java
long division, kept exact here).  The batched getters read the port's
torch tensors on the host and reduce in int64 there, as the JAX
package's do.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np


def _host(a) -> np.ndarray:
    """A tensor (on any device) or an array as a host numpy array."""
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


class Stat:
    def fields(self) -> List[str]:
        raise NotImplementedError

    def get(self, field_name: str) -> int:
        raise NotImplementedError

    def create_from_value(self, vals: Dict[str, int]) -> "Stat":
        raise NotImplementedError


def avg(stats: Sequence[Stat]) -> Stat:
    """Field-by-field average, Java integer division (StatsHelper.java:31-54)."""
    if not stats:
        raise ValueError("no stats")
    if len(stats) == 1:
        return stats[0]
    vals: Dict[str, int] = {}
    for f in stats[0].fields():
        for s in stats:
            vals[f] = vals.get(f, 0) + s.get(f)
    n = len(stats)
    for f in vals:
        v = vals[f]
        # Java long division truncates toward zero
        vals[f] = -((-v) // n) if v < 0 else v // n
    return stats[0].create_from_value(vals)


class Counter(Stat):
    def __init__(self, val: int):
        self.count = int(val)

    def fields(self) -> List[str]:
        return ["count"]

    def get(self, field_name: str) -> int:
        return self.count

    def create_from_value(self, vals: Dict[str, int]) -> "Counter":
        return Counter(vals["count"])

    def __repr__(self) -> str:
        return f"Counter{{count={self.count}}}"


class SimpleStats(Stat):
    def __init__(self, min_: int, max_: int, avg_: int):
        self.min = int(min_)
        self.max = int(max_)
        self.avg = int(avg_)

    def fields(self) -> List[str]:
        return ["min", "max", "avg"]

    def get(self, field_name: str) -> int:
        return {"min": self.min, "max": self.max, "avg": self.avg}[field_name]

    def create_from_value(self, vals: Dict[str, int]) -> "SimpleStats":
        return SimpleStats(vals["min"], vals["max"], vals["avg"])

    def __repr__(self) -> str:
        return f"min: {self.min}, max:{self.max}, avg:{self.avg}"


def get_stats_on(nodes: Sequence, get: Callable) -> SimpleStats:
    """min/max/avg of a node getter (StatsHelper.java:127-140); avg is Java
    long division by node count."""
    mn = 2**63 - 1
    mx = -(2**63)
    tot = 0
    for n in nodes:
        v = get(n)
        tot += v
        mn = min(mn, v)
        mx = max(mx, v)
    a = tot // len(nodes) if tot >= 0 else -((-tot) // len(nodes))
    return SimpleStats(mn, mx, a)


def get_done_at(nodes) -> SimpleStats:
    return get_stats_on(nodes, lambda n: n.done_at)


def get_msg_received(nodes) -> SimpleStats:
    return get_stats_on(nodes, lambda n: n.msg_received)


class StatsGetter:
    def fields(self) -> List[str]:
        raise NotImplementedError

    def get(self, live_nodes) -> Stat:
        raise NotImplementedError


class SimpleStatsGetter(StatsGetter):
    def fields(self) -> List[str]:
        return ["min", "max", "avg"]


class DoneAtStatGetter(SimpleStatsGetter):
    def get(self, live_nodes) -> Stat:
        return get_done_at(live_nodes)


class MsgReceivedStatGetter(SimpleStatsGetter):
    def get(self, live_nodes) -> Stat:
        return get_msg_received(live_nodes)


class CounterStatsGetter(StatsGetter):
    """Counts live nodes matching a predicate (the anonymous StatsGetter
    pattern used in e.g. P2PFlood.floodTime)."""

    def __init__(self, pred: Callable):
        self._pred = pred

    def fields(self) -> List[str]:
        return ["count"]

    def get(self, live_nodes) -> Stat:
        return Counter(sum(1 for n in live_nodes if self._pred(n)))


# -- batched-engine adapters -------------------------------------------------
# The same Stat/StatsGetter shape over SoA columns and telemetry counters:
# sweep drivers and the /w/sweep endpoint reduce batched outputs with the
# identical field contract (min/max/avg, Java long division) the host-side
# getters expose, so downstream consumers never see two schemas.


def get_stats_on_array(values) -> SimpleStats:
    """min/max/avg of a value array (any shape), Java long division —
    the vectorized twin of get_stats_on."""
    v = _host(values).astype(np.int64).reshape(-1)
    if v.size == 0:
        raise ValueError("no values")
    tot = int(v.sum())
    a = tot // v.size if tot >= 0 else -((-tot) // v.size)
    return SimpleStats(int(v.min()), int(v.max()), a)


class BatchedStatsGetter(StatsGetter):
    """SimpleStats over a SimState node column, reduced across every
    (replica, node) pair with the node live.  `get` accepts either a
    batched SimState (leading replica axes collapse) or a plain array."""

    def __init__(self, column: str):
        self.column = column

    def fields(self) -> List[str]:
        return ["min", "max", "avg"]

    def get(self, state_or_values) -> Stat:
        if hasattr(state_or_values, self.column):
            state = state_or_values
            vals = _host(getattr(state, self.column))
            live = ~_host(state.down)
            return get_stats_on_array(vals[live])
        return get_stats_on_array(state_or_values)


class DoneAtBatchedStatGetter(BatchedStatsGetter):
    def __init__(self):
        super().__init__("done_at")


class MsgReceivedBatchedStatGetter(BatchedStatsGetter):
    def __init__(self):
        super().__init__("msg_received")


class TelemetryCounterStatGetter(StatsGetter):
    """Counter over an in-graph telemetry field (telemetry.TelemetryState
    on a state's `tele` side-car), summed over replicas and — unless a
    specific mtype index is given — over message types."""

    def __init__(self, field: str, mtype: "int | None" = None):
        self.field = field
        self.mtype = mtype

    def fields(self) -> List[str]:
        return ["count"]

    def get(self, state) -> Stat:
        tele = state.tele if hasattr(state, "tele") else state
        if tele == ():
            raise ValueError(
                "state has no telemetry side-car — build the engine with "
                "telemetry=TelemetryConfig(...)"
            )
        a = _host(getattr(tele, self.field))
        if self.mtype is not None:
            a = a[..., self.mtype]
        return Counter(int(a.sum()))
