"""Cost attribution on the card: what a run costs the machine.

  xla_cost.py  the cost and memory of one call of an entry point (wall
               seconds, kernel launches and device ms, the allocator's
               peak) — the run cache's per-program summary
               (parallel.replica_shard.run_cache_metrics).
  hbm.py       the state-leaf memory model: bytes a replica from the
               actual state leaves, memory-bounded replicas per card.
  ablation.py  the config-ablation matrix of the flagship (channel
               depth, boundary view, wheel, score cache, telemetry,
               faults) and the ranked per-tick lever report.
  probe.py     the device record (platform, name, count, power limit)
               as run-record fields and Prometheus families.
  budget.py    the feasibility arithmetic: measured ticks a sim x
               memory-bounded replicas per card -> the required tick us
               for 21 sims/s a card (data/BUDGET.json, written by
               chip_smoke.py's profiling phase).
"""

from .ablation import (
    ablation_matrix,
    flagship_params,
    format_lever_report,
    lever_report,
    smoke_ablation_configs,
)
from .budget import (
    budget_from_parts,
    budget_staleness,
    load_budget,
    required_tick_us,
)
from .hbm import hbm_report, replicas_per_chip, state_bytes_per_replica
from .probe import add_probe_metrics, device_record, probe_verdict_fields
from .xla_cost import (
    compiled_cost_summary,
    cost_analysis_dict,
    format_bytes,
    memory_analysis_dict,
    record_call,
)

__all__ = [
    "ablation_matrix",
    "add_probe_metrics",
    "budget_from_parts",
    "budget_staleness",
    "compiled_cost_summary",
    "cost_analysis_dict",
    "device_record",
    "flagship_params",
    "format_bytes",
    "format_lever_report",
    "hbm_report",
    "lever_report",
    "load_budget",
    "memory_analysis_dict",
    "probe_verdict_fields",
    "record_call",
    "replicas_per_chip",
    "required_tick_us",
    "smoke_ablation_configs",
    "state_bytes_per_replica",
]
