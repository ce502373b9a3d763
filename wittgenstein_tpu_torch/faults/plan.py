"""The host-side fault-plan builder over FaultState.

Port of the JAX package's faults/plan.py.  A `FaultPlan` is what a
scenario writes — named, validated, chainable calls — and
`plan.lower(n_nodes, n_msg_types, device)` compiles it into the
`FaultState` the engine carries.  `lower_plans` stacks a list of plans
(None = the fault-free control) along a new leading replica axis, so one
`run_ms_batched` call runs a different schedule per replica:

    fs = lower_plans([None, FaultPlan("crash").crash(range(10), at=200)],
                     net.n_nodes, net.protocol.n_msg_types(), device=net.device)
    fnet, fstates = net.with_faults(replicate_state(state, 2), FaultConfig(), fs)

All times are sim-time ms with the window convention `start <= t < end`
(end=None = forever).  `fault_state_digest` and `plan_digest` give the
JAX package's strings for the same plan.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .state import INT_MAX, FaultState, neutral_fault_state, stack_fault_states


class FaultPlanError(ValueError):
    """A fault plan that cannot mean what it says: reversed windows,
    rates outside their domain, or nodes or mtypes outside the
    population.  Raised when the plan is built where possible, else when
    it is lowered — never silently lowered to a no-op lane."""


def _window(start, end, what: str) -> Tuple[int, int]:
    start = int(start)
    end = int(INT_MAX) if end is None else int(end)
    if start < 0:
        raise FaultPlanError(f"{what}: start={start} must be >= 0")
    if end <= start:
        raise FaultPlanError(f"{what}: end={end} must be > start={start}")
    return start, end


@dataclasses.dataclass
class FaultPlan:
    """One replica's fault schedule.  Builder methods return self so
    plans chain; each lane may be configured at most once per plan
    (sweep over plans, not over calls, for multi-phase scenarios)."""

    label: str = "faults"
    _crashes: List[Tuple[tuple, int, int]] = dataclasses.field(
        default_factory=list
    )
    _partition: Optional[Tuple[Sequence[int], int, int]] = None
    _drop: Optional[Tuple[Optional[Sequence[int]], int, int, int]] = None
    _inflate: Optional[
        Tuple[Optional[Sequence[int]], int, int, int, int]
    ] = None
    _silence: Optional[Tuple[tuple, int, int]] = None
    _delay: Optional[Tuple[tuple, int, int, int]] = None

    # -- builder methods -----------------------------------------------------
    def crash(self, nodes, at: int, recover: Optional[int] = None):
        """Crash `nodes` for ticks `at <= t < recover` (recover=None =
        forever).  crashed nodes neither send nor receive; sender
        counters still tick, mirroring the oracle's send-time check.
        For nodes dead from t=0 prefer init_state(down=...), which also
        skips their initial emissions like the oracle's never-started
        nodes."""
        at, recover = _window(at, recover, f"crash({self.label})")
        self._crashes.append((tuple(int(i) for i in nodes), at, recover))
        return self

    def partition(self, groups, start: int, end: Optional[int] = None):
        """Split the network into link groups for the window: `groups`
        maps node id -> group id (any int labels); cross-group messages
        are dropped at send and on arrival while active."""
        if self._partition is not None:
            raise FaultPlanError(f"{self.label}: partition() already set")
        start, end = _window(start, end, f"partition({self.label})")
        self._partition = (np.asarray(groups), start, end)
        return self

    def drop(self, per_mille: int, mtypes=None, start: int = 0,
             end: Optional[int] = None):
        """Drop each in-window send with probability per_mille/1000,
        from a dedicated RNG stream (base latency draws untouched).
        mtypes=None applies to every message type."""
        if self._drop is not None:
            raise FaultPlanError(f"{self.label}: drop() already set")
        per_mille = int(per_mille)
        if not 0 <= per_mille <= 1000:
            raise FaultPlanError(
                f"drop({self.label}): per_mille={per_mille} outside [0,1000]"
            )
        start, end = _window(start, end, f"drop({self.label})")
        self._drop = (mtypes, per_mille, start, end)
        return self

    def inflate(self, multiplier_pm: int = 1000, add_ms: int = 0,
                mtypes=None, start: int = 0, end: Optional[int] = None):
        """Inflate in-window sampled latencies: lat' = lat *
        multiplier_pm // 1000 + add_ms (per-mille multiplier; 2000 =
        2x).  mtypes=None applies to every message type."""
        if self._inflate is not None:
            raise FaultPlanError(f"{self.label}: inflate() already set")
        multiplier_pm, add_ms = int(multiplier_pm), int(add_ms)
        if multiplier_pm < 0 or add_ms < 0:
            raise FaultPlanError(
                f"inflate({self.label}): multiplier_pm/add_ms must be >= 0"
            )
        start, end = _window(start, end, f"inflate({self.label})")
        self._inflate = (mtypes, multiplier_pm, add_ms, start, end)
        return self

    def silence(self, nodes, start: int = 0, end: Optional[int] = None):
        """Byzantine silence: `nodes` emit nothing while active (their
        counters still tick — observers cannot tell a silent node from
        a lossy link, which is the point)."""
        if self._silence is not None:
            raise FaultPlanError(f"{self.label}: silence() already set")
        start, end = _window(start, end, f"silence({self.label})")
        self._silence = (tuple(int(i) for i in nodes), start, end)
        return self

    def delay(self, nodes, delay_ms: int, start: int = 0,
              end: Optional[int] = None):
        """Byzantine delay: every message `nodes` send while active
        arrives delay_ms later than the latency model sampled."""
        if self._delay is not None:
            raise FaultPlanError(f"{self.label}: delay() already set")
        delay_ms = int(delay_ms)
        if delay_ms < 0:
            raise FaultPlanError(f"delay({self.label}): delay_ms must be >= 0")
        start, end = _window(start, end, f"delay({self.label})")
        self._delay = (tuple(int(i) for i in nodes), delay_ms, start, end)
        return self

    # -- lowering ------------------------------------------------------------
    def _check_nodes(self, nodes, n_nodes, what):
        for i in nodes:
            if not 0 <= i < n_nodes:
                raise FaultPlanError(
                    f"{what}({self.label}): node {i} outside [0,{n_nodes})"
                )

    def _mtype_rows(self, mtypes, n_msg_types, what):
        if mtypes is None:
            return list(range(n_msg_types))
        rows = [int(m) for m in mtypes]
        for m in rows:
            if not 0 <= m < n_msg_types:
                raise FaultPlanError(
                    f"{what}({self.label}): mtype {m} outside "
                    f"[0,{n_msg_types})"
                )
        return rows

    def lower(self, n_nodes: int, n_msg_types: int, device=None) -> FaultState:
        """Compile to the engine's FaultState of one replica, on `device`
        (None = CUDA, as every entry point)."""
        from ..engine.core import resolve_device  # the engine imports this package

        dev = resolve_device(device)
        fs = FaultState(
            crash_at=np.full(n_nodes, INT_MAX, np.int32),
            recover_at=np.full(n_nodes, INT_MAX, np.int32),
            group=np.zeros(n_nodes, np.int32),
            part_start=np.asarray(INT_MAX, np.int32),
            part_end=np.asarray(INT_MAX, np.int32),
            drop_pm=np.zeros(n_msg_types, np.int32),
            drop_start=np.asarray(INT_MAX, np.int32),
            drop_end=np.asarray(INT_MAX, np.int32),
            infl_pm=np.full(n_msg_types, 1000, np.int32),
            infl_add=np.zeros(n_msg_types, np.int32),
            infl_start=np.asarray(INT_MAX, np.int32),
            infl_end=np.asarray(INT_MAX, np.int32),
            byz_silent=np.zeros(n_nodes, bool),
            byz_delay=np.zeros(n_nodes, np.int32),
            byz_start=np.asarray(INT_MAX, np.int32),
            byz_end=np.asarray(INT_MAX, np.int32),
            dropped_by_fault=np.zeros(n_msg_types, np.int32),
            delayed_by_fault=np.zeros(n_msg_types, np.int32),
        )
        for nodes, at, recover in self._crashes:
            self._check_nodes(nodes, n_nodes, "crash")
            idx = list(nodes)
            fs.crash_at[idx] = at
            fs.recover_at[idx] = recover
        if self._partition is not None:
            groups, start, end = self._partition
            if groups.shape != (n_nodes,):
                raise FaultPlanError(
                    f"partition({self.label}): groups shape {groups.shape} "
                    f"!= ({n_nodes},)"
                )
            fs.group[:] = groups.astype(np.int32)
            fs.part_start[...] = start
            fs.part_end[...] = end
        if self._drop is not None:
            mtypes, pm, start, end = self._drop
            rows = self._mtype_rows(mtypes, n_msg_types, "drop")
            fs.drop_pm[rows] = pm
            fs.drop_start[...] = start
            fs.drop_end[...] = end
        if self._inflate is not None:
            mtypes, mult, add, start, end = self._inflate
            rows = self._mtype_rows(mtypes, n_msg_types, "inflate")
            fs.infl_pm[rows] = mult
            fs.infl_add[rows] = add
            fs.infl_start[...] = start
            fs.infl_end[...] = end
        byz_windows = []
        if self._silence is not None:
            nodes, start, end = self._silence
            self._check_nodes(nodes, n_nodes, "silence")
            fs.byz_silent[list(nodes)] = True
            byz_windows.append((start, end))
        if self._delay is not None:
            nodes, delay_ms, start, end = self._delay
            self._check_nodes(nodes, n_nodes, "delay")
            fs.byz_delay[list(nodes)] = delay_ms
            byz_windows.append((start, end))
        if byz_windows:
            if len(set(byz_windows)) > 1:
                raise FaultPlanError(
                    f"{self.label}: silence() and delay() share one "
                    f"Byzantine window; got {byz_windows}"
                )
            fs.byz_start[...] = byz_windows[0][0]
            fs.byz_end[...] = byz_windows[0][1]
        return FaultState(*[torch.from_numpy(np.array(a)).to(dev) for a in fs])

    def describe(self) -> dict:
        """JSON-friendly summary for reports/run records."""
        out = {"label": self.label}
        if self._crashes:
            out["crashes"] = [
                {"nodes": len(n), "at": a,
                 "recover": None if r == int(INT_MAX) else r}
                for n, a, r in self._crashes
            ]
        if self._partition is not None:
            g, s, e = self._partition
            out["partition"] = {
                "groups": int(len(np.unique(g))), "start": s,
                "end": None if e == int(INT_MAX) else e,
            }
        if self._drop is not None:
            m, pm, s, e = self._drop
            out["drop"] = {"per_mille": pm, "start": s,
                           "end": None if e == int(INT_MAX) else e}
        if self._inflate is not None:
            m, mult, add, s, e = self._inflate
            out["inflate"] = {"multiplier_pm": mult, "add_ms": add,
                              "start": s,
                              "end": None if e == int(INT_MAX) else e}
        if self._silence is not None:
            n, s, e = self._silence
            out["silence"] = {"nodes": len(n), "start": s,
                              "end": None if e == int(INT_MAX) else e}
        if self._delay is not None:
            n, d, s, e = self._delay
            out["delay"] = {"nodes": len(n), "delay_ms": d, "start": s,
                            "end": None if e == int(INT_MAX) else e}
        return out



def lower_plans(plans, n_nodes: int, n_msg_types: int, device=None) -> FaultState:
    """Lower a list of plans (None = the fault-free control row) and stack
    them along a new leading replica axis.  Each distinct plan object is
    lowered once and its rows gathered, so a sweep of R replicas over a
    few plans costs a few lowerings."""
    from ..engine.core import resolve_device

    dev = resolve_device(device)
    distinct, rows = {}, []
    for p in plans:
        rows.append(distinct.setdefault(id(p), (len(distinct), p))[0])
    lowered = stack_fault_states([
        neutral_fault_state(n_nodes, n_msg_types, dev) if p is None
        else p.lower(n_nodes, n_msg_types, dev)
        for _, p in distinct.values()
    ])
    idx = torch.as_tensor(rows, dtype=torch.int64, device=dev)
    return FaultState(*[a.index_select(0, idx) for a in lowered])


def fault_state_digest(fs: FaultState) -> str:
    """Stable content digest of one lowered schedule: field names, leaf
    dtypes and shapes, and bytes, hashed in field order — the JAX
    package's string for the same schedule."""
    h = hashlib.blake2b(digest_size=16)
    for name, leaf in zip(fs._fields, fs):
        a = np.asarray(leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else leaf)
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(repr(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def plan_digest(plan: Optional["FaultPlan"], n_nodes: int, n_msg_types: int) -> str:
    """fault_state_digest of `plan` lowered at this population size (None =
    the neutral control schedule)."""
    fs = (neutral_fault_state(n_nodes, n_msg_types, "cpu") if plan is None
          else plan.lower(n_nodes, n_msg_types, "cpu"))
    return fault_state_digest(fs)
