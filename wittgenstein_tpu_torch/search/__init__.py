"""Adversary search: batched black-box optimization over FaultPlan space.

The fault side-car makes per-replica schedules data (faults/state.py),
and `scenarios.sweep.run_fault_sweep` evaluates a heterogeneous list of
FaultPlans in one `run_ms_batched` run — a population evaluator.  This
package closes the loop: a bounded genome lowers to a FaultPlan
(genome.py), per-protocol scalar objectives read the sweep records
(objectives.py), and batched optimizers — seeded random search, a (μ,λ)
diagonal-covariance ES, a successive-halving bandit — spend one
`run_fault_sweep` call per generation (optimizers.py, driver.py).
Discovered attacks are pinned as replayable regression scenarios
(`scenarios/regressions/*.json`).

The port's copy of the JAX package's search: the optimizers are the same
host-side numpy, so the same seeds give the same genomes, and the sweep
is bit-identical, so they give the same scores.
"""

from .driver import (
    SEARCH_COUNTERS,
    SearchConfig,
    SearchDriver,
    baseline_scores,
    optimize_env_policy,
    search_metrics,
    static_baseline_plans,
)
from .genome import FaultGenome, GeneSpec, GenomeSpec
from .objectives import (
    OBJECTIVES,
    Objective,
    get_objective,
    pareto_frontier,
    score_records,
)
from .optimizers import (
    EvolutionStrategy,
    RandomSearch,
    SuccessiveHalving,
    make_optimizer,
)

__all__ = [
    "EvolutionStrategy",
    "FaultGenome",
    "GeneSpec",
    "GenomeSpec",
    "OBJECTIVES",
    "Objective",
    "RandomSearch",
    "SEARCH_COUNTERS",
    "SearchConfig",
    "SearchDriver",
    "SuccessiveHalving",
    "baseline_scores",
    "get_objective",
    "make_optimizer",
    "optimize_env_policy",
    "pareto_frontier",
    "score_records",
    "search_metrics",
    "static_baseline_plans",
]
