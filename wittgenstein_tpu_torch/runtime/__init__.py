"""Host runtime of the port: the lock registry and its tracer.

The supervised chunked executor, its error taxonomy and its retry,
watchdog and degrade policies are not ported yet; only the registered
locks the flight recorder takes are.
"""

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
