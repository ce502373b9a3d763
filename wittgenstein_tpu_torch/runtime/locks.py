"""Named, ranked host locks with optional runtime order tracing.

Every lock the port's host code constructs is named in `LOCK_HIERARCHY`,
a total acquisition order (rank = position): a thread holding a lock may
only acquire locks of strictly higher rank, so two code paths that keep
the order cannot deadlock on these locks.  The port constructs only the
flight recorder's two locks so far (`obs/recorder.py`); the rows keep
the JAX package's names and relative order, so a rank means the same
thing in both packages.

`TracedLock` is a `threading.Lock` wrapper.  Unarmed, an acquire is one
module-flag read and the bare acquire.  Armed (`WITT_LOCK_TRACE=1` in
the environment, or `arm_lock_trace()`), each acquisition is timed and
checked against the locks the thread already holds; a rank inversion or
a cycle in the cross-thread acquisition graph is recorded once per
(held, acquiring) pair and emitted as a `lock-order-violation` event on
the process-default flight recorder.  `lock_trace_status()` reads the
wait times and violations.

Imports only the standard library.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Tuple

__all__ = [
    "LOCK_HIERARCHY",
    "LOCK_RANKS",
    "LockSpec",
    "TracedLock",
    "arm_lock_trace",
    "lock_trace_status",
    "make_lock",
    "reset_lock_trace",
]


@dataclass(frozen=True)
class LockSpec:
    """One registry row: the lock's name and what it guards."""

    name: str
    doc: str = ""


# outermost (rank 0) to innermost
LOCK_HIERARCHY: Tuple[LockSpec, ...] = (
    LockSpec(
        "obs.recorder_default",
        doc="process-default recorder singleton latch (obs/recorder.py)",
    ),
    LockSpec(
        "obs.recorder",
        doc="flight-recorder ring (obs/recorder.py); holds its own fsync I/O "
        "by design (tail-safety beats latency), so it is the innermost rank",
    ),
)

LOCK_RANKS: Dict[str, int] = {spec.name: rank for rank, spec in enumerate(LOCK_HIERARCHY)}


def _env_armed() -> bool:
    return os.environ.get("WITT_LOCK_TRACE", "") not in ("", "0", "off")


_armed: bool = _env_armed()
_tls = threading.local()
# guards the structures below; only ever the innermost acquisition and
# never held across a callback, so it cannot take part in a cycle
_state_lock = threading.Lock()
_edges: Dict[Tuple[str, str], int] = {}
_violations: List[dict] = []
_violation_pairs: set = set()
_wait_stats: Dict[str, List[float]] = {}  # name -> [count, total_s, max_s]
_wait_samples: deque = deque(maxlen=4096)


def arm_lock_trace(on: bool = True) -> None:
    """Turn tracing on or off at run time (`WITT_LOCK_TRACE` sets the
    default at import)."""
    global _armed
    _armed = bool(on)


def reset_lock_trace() -> None:
    """Clear the recorded graph, violations and wait times (the armed flag
    stays as it is)."""
    with _state_lock:
        _edges.clear()
        _violations.clear()
        _violation_pairs.clear()
        _wait_stats.clear()
        _wait_samples.clear()


def _held_stack() -> list:
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = _tls.held = []
    return stack


def _has_path(src: str, dst: str) -> bool:
    """Is `dst` reachable from `src` in the observed edge graph?"""
    seen = set()
    frontier = [src]
    while frontier:
        node = frontier.pop()
        if node == dst:
            return True
        if node in seen:
            continue
        seen.add(node)
        frontier.extend(b for (a, b) in _edges if a == node)
    return False


class TracedLock:
    """A named, hierarchy-ranked `threading.Lock` (module docstring)."""

    __slots__ = ("name", "rank", "_lock")

    def __init__(self, name: str):
        if name not in LOCK_RANKS:
            raise ValueError(
                f"lock {name!r} is not in LOCK_HIERARCHY; register it "
                "in runtime/locks.py before constructing it"
            )
        self.name = name
        self.rank = LOCK_RANKS[name]
        self._lock = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if not _armed or getattr(_tls, "tracing", False):
            return self._lock.acquire(blocking, timeout)
        _tls.tracing = True
        try:
            held = _held_stack()
            if held:
                self._audit(held)
            t0 = time.perf_counter()
        finally:
            _tls.tracing = False
        ok = self._lock.acquire(blocking, timeout)
        if not _armed:
            return ok
        _tls.tracing = True
        try:
            if ok:
                waited = time.perf_counter() - t0
                _held_stack().append(self)
                with _state_lock:
                    st = _wait_stats.setdefault(self.name, [0, 0.0, 0.0])
                    st[0] += 1
                    st[1] += waited
                    st[2] = max(st[2], waited)
                    _wait_samples.append(waited)
        finally:
            _tls.tracing = False
        return ok

    def release(self) -> None:
        self._lock.release()
        held = getattr(_tls, "held", None)
        if held:
            for i in range(len(held) - 1, -1, -1):
                if held[i] is self:
                    del held[i]
                    break

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "TracedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"TracedLock({self.name!r}, rank={self.rank})"

    def _audit(self, held: list) -> None:
        """Record the edges held -> self; a rank inversion or a closed
        cycle is a violation, recorded once per pair."""
        fresh: List[dict] = []
        with _state_lock:
            for h in held:
                pair = (h.name, self.name)
                _edges[pair] = _edges.get(pair, 0) + 1
                bad = None
                if self.rank <= h.rank:
                    bad = (
                        "rank inversion" if self.rank < h.rank
                        else "re-acquisition of a held non-reentrant lock"
                    )
                elif _has_path(self.name, h.name):
                    bad = "acquisition-graph cycle"
                if bad and pair not in _violation_pairs:
                    _violation_pairs.add(pair)
                    v = {
                        "held": h.name,
                        "heldRank": h.rank,
                        "acquiring": self.name,
                        "acquiringRank": self.rank,
                        "kind": bad,
                        "thread": threading.current_thread().name,
                    }
                    _violations.append(v)
                    fresh.append(v)
        for v in fresh:
            _emit_violation(v)


def _emit_violation(v: dict) -> None:
    """A `lock-order-violation` event on the default recorder; best
    effort, the tracer must never fail its caller."""
    try:
        from ..obs.recorder import get_recorder

        get_recorder().record(
            "lock-order-violation",
            held=v["held"],
            acquiring=v["acquiring"],
            held_rank=v["heldRank"],
            acquiring_rank=v["acquiringRank"],
            cycle_kind=v["kind"],
            thread=v["thread"],
        )
    except Exception:
        pass


def make_lock(name: str) -> TracedLock:
    """Construct the registered lock `name`."""
    return TracedLock(name)


def lock_trace_status() -> dict:
    """Armed flag, violations, the largest and 99th-percentile wait, and
    acquisitions per lock."""
    with _state_lock:
        samples = sorted(_wait_samples)
        per_lock = {
            name: {
                "acquisitions": int(st[0]),
                "waitSecondsTotal": round(st[1], 6),
                "maxWaitS": round(st[2], 6),
            }
            for name, st in sorted(_wait_stats.items())
        }
        violations = [dict(v) for v in _violations]
    p99 = samples[min(len(samples) - 1, int(0.99 * len(samples)))] if samples else 0.0
    return {
        "armed": _armed,
        "violationCount": len(violations),
        "violations": violations,
        "maxWaitS": round(max((s[2] for s in _wait_stats.values()), default=0.0), 6),
        "waitP99S": round(p99, 6),
        "perLock": per_lock,
    }
