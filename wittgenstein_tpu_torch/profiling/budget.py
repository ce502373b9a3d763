"""The feasibility budget: the per-tick wall time the card may take.

North star: 21 sims/s per card of flagship Handel at 4096 nodes.  The
budget is arithmetic once two quantities are measured:

  ticks_per_sim   the ticks one sim executes (fewer than SIM_MS when the
                  stop test ends the run after the last node finishes);
  replicas        the memory-bounded replicas per card at the flagship's
                  state layout (profiling.hbm's model).

With R replicas advancing in lockstep:

  required_tick_us = R / (21 * ticks_per_sim) * 1e6

The JAX package's arithmetic, unchanged.  The port's budget document is
`wittgenstein_tpu_torch/data/BUDGET.json`, written from the card's own
measurements by chip_smoke.py's `profiling` phase (the repo root's
BUDGET.json holds the JAX package's TPU figures and is never read here).
"""

from __future__ import annotations

import json
import os
from typing import Optional

NORTH_STAR_SIMS_PER_SEC = 21.0
BUDGET_PATH = os.path.join("data", "BUDGET.json")  # under the package directory
BUDGET_SCHEMA = "witt-budget/v1"


def required_tick_us(
    replicas: int,
    ticks_per_sim: float,
    sims_per_sec: float = NORTH_STAR_SIMS_PER_SEC,
) -> float:
    """Max per-tick wall time (us) for `replicas` lockstep replicas to
    yield `sims_per_sec` finished sims per second when one sim runs
    `ticks_per_sim` ticks."""
    if replicas <= 0 or ticks_per_sim <= 0 or sims_per_sec <= 0:
        raise ValueError(
            f"replicas={replicas}, ticks_per_sim={ticks_per_sim},"
            f" sims_per_sec={sims_per_sec} must all be positive"
        )
    return replicas / (sims_per_sec * ticks_per_sim) * 1e6


def budget_from_parts(
    ticks_per_sim: float,
    hbm: dict,
    measured: Optional[dict] = None,
    sims_per_sec: float = NORTH_STAR_SIMS_PER_SEC,
    config: Optional[dict] = None,
) -> dict:
    """Assemble the BUDGET.json document.  `hbm` is
    profiling.hbm.hbm_report() output (its model.replicas bounds R);
    `measured` optionally carries the measured tick cost, so the gap to
    the budget is stated in the document itself."""
    replicas = int(hbm["model"]["replicas"])
    tick_us = required_tick_us(replicas, ticks_per_sim, sims_per_sec)
    doc = {
        "schema": BUDGET_SCHEMA,
        "north_star_sims_per_sec_per_chip": sims_per_sec,
        "config": config or {},
        "ticks_per_sim": round(float(ticks_per_sim), 1),
        "hbm": hbm,
        "replicas_per_chip": replicas,
        "required_tick_us": round(tick_us, 2),
        "derivation": (
            f"required_tick_us = replicas / (sims_per_sec * ticks_per_sim)"
            f" * 1e6 = {replicas} / ({sims_per_sec} * {ticks_per_sim:.0f})"
            f" * 1e6"
        ),
    }
    if measured:
        doc["measured"] = measured
        mt = measured.get("tick_us")
        if mt:
            doc["headroom_factor"] = round(tick_us / mt, 3)
    return doc


def load_budget(path: Optional[str] = None, root: Optional[str] = None) -> Optional[dict]:
    """Read the port's BUDGET.json (`data/BUDGET.json` under `root`, the
    package directory by default); None when absent, unparseable or of
    another schema."""
    if path is None:
        root = root or os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        path = os.path.join(root, BUDGET_PATH)
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if doc.get("schema") != BUDGET_SCHEMA:
        return None
    return doc


def budget_staleness(budget: dict, floor: dict) -> Optional[str]:
    """Why `budget` is stale relative to a floor document, or None when
    fresh.  Stale = the floor was recorded after the budget, or the
    budget has no timestamp at all.  Only the recorded dates are
    compared (ISO dates order lexicographically)."""
    b_rec = budget.get("recorded")
    f_rec = floor.get("recorded")
    if not b_rec:
        return "budget has no 'recorded' timestamp"
    if f_rec and str(b_rec) < str(f_rec):
        return (
            f"budget recorded {b_rec} predates the floor recorded {f_rec}"
            f" — rerun chip_smoke.py --phases flagship,profiling on the card"
        )
    return None
