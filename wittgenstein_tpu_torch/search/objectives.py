"""Attacker objectives over existing result surfaces.

Every objective maps ONE `run_fault_sweep` record (availability, done-at
quantiles, fault counters — scenarios/sweep.py) plus the sweep horizon
to a scalar where HIGHER = stronger attack; optimizers maximize.  The
env-policy path (protocols/handel_env.py rollouts) reuses the same
registry through records shaped `{"reward_ratio": x}` — miner revenue
for the ethpow BatchedMinerEnv, final undone fraction for the Handel
attacker.  A pinned regression file names its objective from this
registry (scenarios/regressions.py).  Numpy only; the names and docs are
the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np


def _p90_or_horizon(record: dict, sim_ms: int) -> float:
    q = record.get("done_at_ms")
    return float(q["p90"]) if q else float(sim_ms)


def _done_at(record: dict, sim_ms: int) -> float:
    # the canonical latency-damage score: p90 completion time with the
    # undone fraction censored at the horizon — monotone in BOTH axes
    # the north-star cares about (later completion, lower availability),
    # so "strictly beats the static sweep" means strictly more damage
    return (
        (1.0 - float(record["availability"])) * float(sim_ms)
        + _p90_or_horizon(record, sim_ms)
    )


def _unavailability(record: dict, sim_ms: int) -> float:
    return 1.0 - float(record["availability"])


def _done_at_max(record: dict, sim_ms: int) -> float:
    q = record.get("done_at_ms")
    return float(q["max"]) if q else float(sim_ms)


def _dropped_total(record: dict, sim_ms: int) -> float:
    return float(sum(record["dropped_by_fault"]))


def _delayed_total(record: dict, sim_ms: int) -> float:
    return float(sum(record["delayed_by_fault"]))


def _reward_ratio(record: dict, sim_ms: int) -> float:
    # env-policy records (miner revenue share / attacker rollout reward)
    return float(record["reward_ratio"])


@dataclasses.dataclass(frozen=True)
class Objective:
    """name -> scalar score(record, sim_ms); higher = stronger attack."""

    name: str
    doc: str
    fn: Callable[[dict, int], float]

    def __call__(self, record: dict, sim_ms: int) -> float:
        return self.fn(record, sim_ms)


OBJECTIVES: Dict[str, Objective] = {
    o.name: o
    for o in (
        Objective(
            "done_at",
            "p90 done-at ms with undone nodes censored at the horizon "
            "(latency damage; the CI-gated default)",
            _done_at,
        ),
        Objective(
            "unavailability",
            "fraction of statically-live nodes NOT done by the deadline",
            _unavailability,
        ),
        Objective(
            "done_at_max",
            "slowest completed node's done-at ms (horizon when none)",
            _done_at_max,
        ),
        Objective(
            "dropped_total",
            "messages the fault lanes dropped (drop + partition)",
            _dropped_total,
        ),
        Objective(
            "delayed_total",
            "messages the fault lanes delayed (inflate + Byzantine)",
            _delayed_total,
        ),
        Objective(
            "reward_ratio",
            "adversary reward share from an env-policy rollout (miner "
            "revenue for ethpow, undone fraction for the Handel attacker)",
            _reward_ratio,
        ),
    )
}


def get_objective(name: str) -> Objective:
    try:
        return OBJECTIVES[name]
    except KeyError:
        raise KeyError(
            f"unknown objective {name!r} (known: "
            + ", ".join(sorted(OBJECTIVES)) + ")"
        ) from None


def score_records(
    records: Sequence[dict], objective: str, sim_ms: int
) -> np.ndarray:
    """One score per sweep record, as float64 (optimizer input)."""
    obj = get_objective(objective)
    return np.array([obj(r, sim_ms) for r in records], np.float64)


def pareto_frontier(
    points: Sequence[Tuple[float, float]],
    maximize: Tuple[bool, bool] = (True, True),
) -> List[int]:
    """Indices of the non-dominated points, in input order (ties kept:
    a point equal to a frontier member on both axes is on the
    frontier).  Used for the availability-vs-latency report: attacker
    view is maximize (unavailability, done-at), one frontier entry per
    distinct trade-off the search discovered."""
    pts = np.asarray(points, np.float64)
    if pts.ndim != 2 or pts.shape[1] != 2:
        raise ValueError(f"points must be [n,2], got {pts.shape}")
    sign = np.array([1.0 if m else -1.0 for m in maximize])
    v = pts * sign  # now maximize both
    keep = []
    for i in range(len(v)):
        dominated = np.any(
            np.all(v >= v[i], axis=1) & np.any(v > v[i], axis=1)
        )
        if not dominated:
            keep.append(i)
    return keep
