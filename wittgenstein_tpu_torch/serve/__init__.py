"""Multi-tenant serving layer: jobs -> compatibility families ->
replica-axis batches -> one program per family (the JAX package's
serve/, ported; the scheduler's module docstring lists the design
differences).
"""

from .jobs import (
    DrainingError,
    Job,
    JobQueue,
    JobSpec,
    JobState,
    QueueFullError,
    SERVE_PROTOCOLS,
    UnknownJobError,
    chunk_schedule,
    plan_from_spec,
    serve_protocol,
)
from .metrics import ServeMetrics, quantile
from .scheduler import BatchScheduler, ScenarioFamily, state_digest

__all__ = [
    "BatchScheduler",
    "DrainingError",
    "Job",
    "JobQueue",
    "JobSpec",
    "JobState",
    "QueueFullError",
    "ScenarioFamily",
    "ServeMetrics",
    "SERVE_PROTOCOLS",
    "UnknownJobError",
    "chunk_schedule",
    "plan_from_spec",
    "quantile",
    "serve_protocol",
    "state_digest",
]
