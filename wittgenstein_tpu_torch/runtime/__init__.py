"""Host runtime of the port: supervised chunked execution with
checkpoint/resume, watchdogs, bounded retry and opt-in degradation
(`Supervisor`), its error taxonomy (`classify`) and policies, and the
lock registry with its tracer.

The JAX package's compile store has no counterpart: the port runs
eagerly and has no compiled programs to persist; its restart cost is
the kernels' nvcc build, which `ops/kernels.py` caches by digest.
"""

from .errors import (
    RETRYABLE_KINDS,
    DeviceLostError,
    DurableRunError,
    FatalRunError,
    LaneFailedError,
    PoisonRowError,
    PreemptedError,
    ResumeMismatchError,
    RetriesExhaustedError,
    RunIncompleteError,
    TransientRunError,
    WatchdogTimeoutError,
    classify,
    reset_taxonomy_counters,
    taxonomy_counters,
)
from .locks import (
    LOCK_HIERARCHY,
    LOCK_RANKS,
    LockSpec,
    TracedLock,
    arm_lock_trace,
    lock_trace_status,
    make_lock,
    reset_lock_trace,
)
from .policy import (
    DegradePolicy,
    RetryPolicy,
    SalvagePolicy,
    WatchdogPolicy,
    WatchdogWorker,
)
from .supervisor import (
    RunReport,
    Supervisor,
    chunk_time_histogram,
    run_with_deadline,
    stable_run_key,
)

__all__ = [
    "LOCK_HIERARCHY",
    "LOCK_RANKS",
    "LockSpec",
    "TracedLock",
    "arm_lock_trace",
    "lock_trace_status",
    "make_lock",
    "reset_lock_trace",
    "DegradePolicy",
    "DeviceLostError",
    "DurableRunError",
    "FatalRunError",
    "LaneFailedError",
    "PoisonRowError",
    "PreemptedError",
    "RETRYABLE_KINDS",
    "ResumeMismatchError",
    "RetriesExhaustedError",
    "RunIncompleteError",
    "RunReport",
    "RetryPolicy",
    "SalvagePolicy",
    "Supervisor",
    "TransientRunError",
    "WatchdogPolicy",
    "WatchdogTimeoutError",
    "WatchdogWorker",
    "chunk_time_histogram",
    "classify",
    "reset_taxonomy_counters",
    "run_with_deadline",
    "stable_run_key",
    "taxonomy_counters",
]
