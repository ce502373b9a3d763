"""Structured error taxonomy for the durable-run supervisor.

The split that matters operationally is TRANSIENT vs FATAL:

- **Transient** failures (device lost, preemption, connection resets)
  are the supervisor's to handle: bounded retry with backoff, replaying
  deterministically from the last host anchor, so the retried run is
  bit-identical to one that never failed.
- **Fatal** failures (watchdog deadline, layout mismatch on resume,
  retries exhausted) stop the run with a typed exception the caller can
  route.

`classify` maps arbitrary exceptions onto the taxonomy.  It reads the
JAX package's marker vocabulary word for word first, so every message
that package classifies gets the same kind here; then the card's own
vocabulary, mapped to the same kinds:

- `torch.cuda.OutOfMemoryError` ("CUDA out of memory") is `transient`,
  as XLA's RESOURCE_EXHAUSTED is;
- a sticky loss of the CUDA context ("an illegal memory access",
  "unspecified launch failure", "uncorrectable ECC error", "GPU has
  fallen off the bus") is `device_lost`: the process's context is gone,
  only a fresh placement can continue;
- a device-side assert is `fatal`: the kernel tripped on its data, and
  replaying the same data trips it again.
"""

from __future__ import annotations

import threading
from collections import Counter

import torch


class DurableRunError(Exception):
    """Base for every structured supervisor failure."""


class TransientRunError(DurableRunError):
    """Worth retrying: the failure is environmental, not semantic."""


class FatalRunError(DurableRunError):
    """Retrying cannot help; the run stops with this as the reason."""


class DeviceLostError(TransientRunError):
    """The accelerator went away mid-run (context loss, worker crash,
    preemption of the device)."""


class PreemptedError(TransientRunError):
    """The host/process was asked to stop (scheduler preemption); state
    up to the last checkpoint survives."""


class WatchdogTimeoutError(FatalRunError):
    """A chunk (with its first-call allowance) exceeded its deadline.
    Fatal in-process: a hung device call cannot be cancelled from
    Python, so the in-process supervisor stops issuing work and reports;
    killing the process is a process-level supervisor's job."""

    def __init__(self, phase: str, deadline_s: float):
        self.phase = phase
        self.deadline_s = deadline_s
        super().__init__(
            f"{phase} exceeded its {deadline_s:.0f}s watchdog deadline"
        )


class RetriesExhaustedError(FatalRunError):
    """The retry policy's attempt budget ran out on transient failures."""

    def __init__(self, attempts: int, last: BaseException):
        self.attempts = attempts
        self.last = last
        super().__init__(
            f"gave up after {attempts} attempts; last failure: "
            f"{type(last).__name__}: {last}"
        )


class ResumeMismatchError(FatalRunError):
    """A checkpoint exists but belongs to a different run (run_key or
    chunk geometry mismatch): resuming would silently mix runs."""


class PoisonRowError(FatalRunError):
    """One row of a packed batch is semantically poisonous: the batch
    failed with it and succeeded without it, or its row could not be
    built.  Quarantining the carrying job is the only fix; retrying the
    batch replays the same poison.  Carries the job id and the original
    failure."""

    def __init__(self, job_id: str, cause: BaseException):
        self.job_id = job_id
        self.cause = cause
        super().__init__(
            f"job {job_id} poisons its batch: "
            f"{type(cause).__name__}: {cause}"
        )


class LaneFailedError(TransientRunError):
    """A dispatch lane's worker thread died.  Transient at fleet level:
    the lane restarts and its work re-runs elsewhere."""

    def __init__(self, lane: int, reason: str = "lane worker died"):
        self.lane = lane
        super().__init__(f"lane {lane}: {reason}")


class RunIncompleteError(DurableRunError):
    """A controlled partial stop (budget exhausted / chunk cap reached).
    Carries the partial RunReport so callers can checkpoint-and-requeue."""

    def __init__(self, message: str, report=None):
        self.report = report
        super().__init__(message)


# the JAX package's vocabulary, word for word: lowercase substrings that
# mark an environmental (retryable) failure in backend exception text
_TRANSIENT_MARKERS = (
    "deadline_exceeded",
    "deadline exceeded",
    "unavailable",
    "resource_exhausted",
    "resource exhausted",
    "preempt",
    "worker crashed",
    "worker process crashed",
    "connection reset",
    "connection refused",
    "broken pipe",
    "socket closed",
    "transport closed",
    "heartbeat",
)

_DEVICE_LOST_MARKERS = (
    "device lost",
    "worker crashed",
    "worker process crashed",
    "tpu is dead",
    "failed to connect",
    "transport closed",
)

# the card's vocabulary (CUDA runtime error strings as torch raises them),
# read after the JAX package's
_CUDA_FATAL_MARKERS = ("device-side assert",)

_CUDA_DEVICE_LOST_MARKERS = (
    "an illegal memory access",
    "unspecified launch failure",
    "uncorrectable ecc error",
    "gpu has fallen off the bus",
)

_CUDA_TRANSIENT_MARKERS = ("cuda out of memory",)


# process-wide taxonomy counters: every classify() call increments its kind
_TAXONOMY_LOCK = threading.Lock()
_TAXONOMY_COUNTS: Counter = Counter()


def taxonomy_counters() -> dict:
    """Snapshot of {kind: count} over every classify() call since
    process start (or the last reset)."""
    with _TAXONOMY_LOCK:
        return dict(_TAXONOMY_COUNTS)


def reset_taxonomy_counters() -> None:
    with _TAXONOMY_LOCK:
        _TAXONOMY_COUNTS.clear()


def _classify(exc: BaseException) -> str:
    if isinstance(exc, PoisonRowError):
        return "poison_row"
    if isinstance(exc, LaneFailedError):
        return "lane_failed"
    if isinstance(exc, DeviceLostError):
        return "device_lost"
    if isinstance(exc, TransientRunError):
        return "transient"
    if isinstance(exc, FatalRunError):
        return "fatal"
    if isinstance(exc, (KeyboardInterrupt, SystemExit)):
        return "fatal"
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return "transient"
    text = str(exc).lower()
    if any(m in text for m in _DEVICE_LOST_MARKERS):
        return "device_lost"
    if any(m in text for m in _TRANSIENT_MARKERS):
        return "transient"
    if any(m in text for m in _CUDA_FATAL_MARKERS):
        return "fatal"
    if any(m in text for m in _CUDA_DEVICE_LOST_MARKERS):
        return "device_lost"
    if any(m in text for m in _CUDA_TRANSIENT_MARKERS):
        return "transient"
    return "fatal"


#: kinds the supervisor may retry; everything else ('fatal',
#: 'poison_row', future additions) must propagate: replaying a semantic
#: failure reproduces it.  lane_failed is retryable: a lane death says
#: nothing about the work it carried.
RETRYABLE_KINDS = frozenset({"transient", "device_lost", "lane_failed"})


def classify(exc: BaseException) -> str:
    """Map an exception to a taxonomy kind: 'transient' | 'device_lost'
    | 'fatal' | 'poison_row' | 'lane_failed'.

    device_lost is a sub-case of transient that also makes the current
    device suspect; the degradation policy keys off it.  Only
    RETRYABLE_KINDS are safe to replay.
    """
    kind = _classify(exc)
    with _TAXONOMY_LOCK:
        _TAXONOMY_COUNTS[kind] += 1
    return kind
