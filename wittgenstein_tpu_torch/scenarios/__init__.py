"""Scenario drivers on the port's batched engine.

The reference's research drivers (HandelScenarios.java:22) run one
configuration at a time through RunMultipleTimes' sequential reseeded
loop.  Here a sweep — (configuration x replica) — runs as stacked
batched computations (`sweep.run_sweep`), reduced to BasicStats rows and
emitted in the CSV shape the reference prints
(`handel_scenarios`).
"""

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
    "SWEEP_COUNTERS",
    "SweepConfig",
    "run_fault_sweep",
    "run_sweep",
    "sweep_counters",
]
