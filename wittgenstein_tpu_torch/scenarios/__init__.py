"""Scenario drivers on the port's batched engine.

The reference's research drivers (HandelScenarios.java:22) run one
configuration at a time through RunMultipleTimes' sequential reseeded
loop.  Here a sweep — (configuration x replica) — runs as stacked
batched computations (`sweep.run_sweep`), reduced to BasicStats rows and
emitted in the CSV shape the reference prints
(`handel_scenarios`).  Pinned adversary regressions (`regressions`)
ride along: discovered attacks frozen as replayable
`scenarios/regressions/*.json` files.  Their names load on first
access (PEP 562): `regressions` replays pins through the search
driver, which imports `sweep` from this package.
"""

_REGRESSIONS = (
    "REGRESSIONS_DIR",
    "SCHEMA",
    "check_regression_doc",
    "list_regressions",
    "load_regression",
    "pin_regression",
    "verify_regression",
)

from .sweep import (
    SWEEP_COUNTERS,
    BasicStats,
    SweepConfig,
    run_fault_sweep,
    run_sweep,
    sweep_counters,
)

__all__ = [
    "BasicStats",
    "REGRESSIONS_DIR",
    "SCHEMA",
    "SWEEP_COUNTERS",
    "SweepConfig",
    "check_regression_doc",
    "list_regressions",
    "load_regression",
    "pin_regression",
    "run_fault_sweep",
    "run_sweep",
    "sweep_counters",
    "verify_regression",
]


def __getattr__(name):
    if name in _REGRESSIONS:
        from . import regressions

        return getattr(regressions, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
