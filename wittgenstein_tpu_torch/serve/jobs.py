"""Job model + queue for the multi-tenant serving layer.

The reference serves one simulation per process behind one global run
lock (ws/WServer.java); a second client gets 503.  The batched engine
inverts that economics: heterogeneous per-replica scenarios — seeds,
FaultPlans, sweepable state-only params — are DATA on the replica axis
of ONE program, so the serving layer's job is admission + grouping, not
time-slicing.  Ported from the JAX package's serve/jobs.py; the one
difference is that ``ServeProtocol.build`` takes the device the family
is built on.  This module owns the host-side half:

  * ``JobSpec``: a client request parsed/validated once at admission —
    protocol name, full params, seed, optional FaultPlan (built from a
    JSON op list by ``plan_from_spec``), sim horizon, execution mode
    (direct vs chunked/preemptible) and priority;
  * ``Job``: the queued unit with a typed lifecycle
    (QUEUED -> RUNNING -> DONE | FAILED | CANCELLED | QUARANTINED,
    the last being the 4xx-style verdict of batch salvage — the spec
    itself is the fault), timestamps for
    the SLO quantiles, a threading.Event for blocking waiters, and a
    cancel flag honored at batch boundaries;
  * ``JobQueue``: a bounded registry + pending list.  Admission control
    is the bound: a full queue raises ``QueueFullError`` carrying a
    Retry-After estimate instead of wedging an HTTP worker — the
    backpressure contract the server maps to 429/503;
  * the serve-side protocol registry (``SERVE_PROTOCOLS``): which
    factories the scheduler may build engine families from, and which
    param fields are per-replica DATA (state-only — safe to vary
    inside one program) versus traced shape/branch params (anything
    else — a different program, scheduler.compat splits the batch).

Scheduling itself — compatibility digests, replica packing, dispatch —
lives in serve/scheduler.py.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import threading
import time
from typing import Callable, Dict, List, Optional


class JobState(str, enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    DONE = "done"
    FAILED = "failed"
    CANCELLED = "cancelled"
    # terminal 4xx-style status: batch salvage proved this job's row is
    # what failed the batch (the batch succeeds without it), so the
    # fault is the SPEC's, not the fleet's — resubmitting unchanged
    # reproduces it.  Distinct from FAILED (a 5xx: the fleet broke).
    QUARANTINED = "quarantined"


#: terminal states: the job's Event is set and its record is immutable
TERMINAL = frozenset({
    JobState.DONE,
    JobState.FAILED,
    JobState.CANCELLED,
    JobState.QUARANTINED,
})


class QueueFullError(Exception):
    """Admission refused: the pending queue is at capacity.  Carries the
    scheduler's Retry-After estimate (seconds) for the HTTP layer."""

    def __init__(self, depth: int, retry_after_s: int):
        super().__init__(
            f"job queue full ({depth} pending); retry in ~{retry_after_s}s"
        )
        self.depth = depth
        self.retry_after_s = retry_after_s


class DrainingError(Exception):
    """Admission refused: the scheduler is in graceful drain (admin
    surface).  Carries the Retry-After hint for the HTTP 503."""

    def __init__(self, retry_after_s: int):
        super().__init__(
            f"scheduler is draining; retry in ~{retry_after_s}s"
        )
        self.retry_after_s = retry_after_s


class UnknownJobError(KeyError):
    pass


# ---------------------------------------------------------------------------
# serve-side protocol registry


@dataclasses.dataclass(frozen=True)
class ServeProtocol:
    """One protocol family the scheduler may serve.

    ``build(params, telemetry, device)`` -> (net, single-replica state)
    on ``device`` with the telemetry side-car armed at construction.
    ``state_only`` names the param fields that are per-replica data
    (distinct values can share one program — the same set sweep.py's
    config grouping uses); every OTHER param is assumed traced and
    splits the compatibility key."""

    name: str
    build: Callable
    state_only: frozenset = frozenset()


def _build_pingpong(params: dict, telemetry, device):
    from ..protocols.pingpong_batched import make_pingpong

    return make_pingpong(
        node_ct=int(params.get("node_ct", 64)),
        node_builder_name=params.get("node_builder_name"),
        network_latency_name=params.get("network_latency_name"),
        capacity=params.get("capacity"),
        wheel_rows=params.get("wheel_rows"),
        telemetry=telemetry,
        device=device,
    )


def _build_p2pflood(params: dict, telemetry, device):
    from ..protocols.p2pflood import P2PFloodParameters
    from ..protocols.p2pflood_batched import make_p2pflood

    p = P2PFloodParameters(**params)
    return make_p2pflood(p, telemetry=telemetry, device=device)


def _build_handel(params: dict, telemetry, device):
    from ..protocols.handel import HandelParameters
    from ..protocols.handel_batched import make_handel

    p = HandelParameters(**params)
    return make_handel(p, telemetry=telemetry, device=device)


def _handel_state_only() -> frozenset:
    # single source of truth: the sweep runner's grouping fields
    from ..scenarios.sweep import _STATE_ONLY_FIELDS

    return _STATE_ONLY_FIELDS


SERVE_PROTOCOLS: Dict[str, ServeProtocol] = {
    "PingPong": ServeProtocol("PingPong", _build_pingpong),
    "P2PFlood": ServeProtocol(
        "P2PFlood",
        _build_p2pflood,
        # dead_node_count maps to init-state down flags (per-replica
        # data would need stacked init states; the factory handles it
        # per build, so it is state-only for grouping purposes)
        frozenset({"dead_node_count"}),
    ),
    "Handel": ServeProtocol("Handel", _build_handel),
}


def serve_protocol(name: str) -> ServeProtocol:
    entry = SERVE_PROTOCOLS.get(name)
    if entry is None:
        raise KeyError(
            f"unknown serve protocol {name!r} "
            f"(known: {sorted(SERVE_PROTOCOLS)})"
        )
    if entry.name == "Handel" and not entry.state_only:
        entry = dataclasses.replace(entry, state_only=_handel_state_only())
        SERVE_PROTOCOLS[name] = entry
    return entry


# ---------------------------------------------------------------------------
# horizon sharding


def chunk_schedule(
    sim_ms: int, chunk_ms: int = 0, quantum_ms: int = 0
) -> List[int]:
    """The exact sequence of run_ms steps a job executes — ONE function
    so the batched path and the singleton reference replay the same
    boundaries (the telemetry loop census is chunk-schedule-dependent,
    so bit-identity requires agreeing on this list).

    Explicit ``chunk_ms`` wins (admission validated divisibility).
    Otherwise a scheduler-level ``quantum_ms`` splits any longer horizon
    into fixed quantum units plus one remainder step, so mixed-simMs
    tenants share one chunked family instead of fragmenting into
    per-horizon programs.  Horizons >= the quantum are
    quantized (sim_ms == quantum is ONE quantum unit — it rides the
    shared chunked family, not a private direct one); shorter horizons
    stay direct (one step)."""
    if chunk_ms:
        return [chunk_ms] * (sim_ms // chunk_ms)
    if quantum_ms and sim_ms >= quantum_ms:
        full, rem = divmod(sim_ms, quantum_ms)
        return [quantum_ms] * full + ([rem] if rem else [])
    return [sim_ms]


# ---------------------------------------------------------------------------
# fault-plan parsing


_PLAN_OPS = ("crash", "partition", "drop", "inflate", "silence", "delay")


def plan_from_spec(ops: Optional[List[dict]], label: str = "job"):
    """Build a FaultPlan from a JSON op list, e.g.::

        [{"op": "crash", "nodes": [1, 2], "at": 100, "recover": 400},
         {"op": "drop", "per_mille": 200, "start": 50}]

    None / empty -> None (the neutral schedule: a fault-free row of a
    fault-enabled program, bit-identical to the fault-free run).  Ops
    map 1:1 onto faults.FaultPlan builder methods; unknown ops or
    malformed windows raise ValueError at ADMISSION, not at dispatch.
    """
    if not ops:
        return None
    from ..faults.plan import FaultPlan

    plan = FaultPlan(label)
    for op in ops:
        kind = op.get("op")
        if kind not in _PLAN_OPS:
            raise ValueError(
                f"unknown fault op {kind!r} (known: {_PLAN_OPS})"
            )
        kw = {k: v for k, v in op.items() if k != "op"}
        getattr(plan, kind)(**kw)
    return plan


# ---------------------------------------------------------------------------
# job model


@dataclasses.dataclass
class JobSpec:
    """One client request, validated at admission.

    chunk_ms > 0 selects the chunked (checkpointed, preemptible)
    execution path; 0 runs the whole horizon in one device call."""

    protocol: str
    params: dict
    seed: int = 0
    plan: object = None  # FaultPlan | None
    plan_ops: Optional[List[dict]] = None  # original JSON, for echo
    sim_ms: int = 1000
    chunk_ms: int = 0
    priority: int = 0
    # attribution identity only — never part of the compatibility key,
    # so tenants pack together freely (isolation is accounting, not
    # placement)
    tenant: str = "default"

    @classmethod
    def from_dict(cls, spec: dict) -> "JobSpec":
        protocol = spec.get("protocol")
        if not protocol:
            raise ValueError("job spec needs a 'protocol'")
        serve_protocol(protocol)  # admission-time existence check
        sim_ms = int(spec.get("simMs", spec.get("sim_ms", 1000)))
        if sim_ms < 1:
            raise ValueError(f"simMs must be >= 1, got {sim_ms}")
        chunk_ms = int(spec.get("chunkMs", spec.get("chunk_ms", 0)))
        if chunk_ms < 0:
            raise ValueError(f"chunkMs must be >= 0, got {chunk_ms}")
        if chunk_ms and sim_ms % chunk_ms != 0:
            raise ValueError(
                f"simMs={sim_ms} must be a multiple of chunkMs={chunk_ms}"
            )
        ops = spec.get("faults")
        tenant = str(spec.get("tenant", spec.get("tenantId", "default")))
        if not tenant:
            raise ValueError("tenant must be a non-empty string")
        return cls(
            protocol=protocol,
            params=dict(spec.get("params", {})),
            seed=int(spec.get("seed", 0)),
            plan=plan_from_spec(ops),
            plan_ops=ops,
            sim_ms=sim_ms,
            chunk_ms=chunk_ms,
            priority=int(spec.get("priority", 0)),
            tenant=tenant,
        )


_JOB_SEQ = itertools.count(1)


@dataclasses.dataclass
class Job:
    """A queued unit of work.  ``kind`` is "batch" (packable onto the
    replica axis) or "legacy" (an opaque thunk — the rerouted /w/sweep
    path — never packed with anything)."""

    spec: Optional[JobSpec]
    compat: str  # pre-dispatch compatibility key (scheduler.pre_key)
    kind: str = "batch"
    thunk: Optional[Callable] = None  # legacy jobs only
    id: str = ""
    seq: int = 0
    state: JobState = JobState.QUEUED
    priority: int = 0
    submitted_at: float = 0.0
    started_at: Optional[float] = None
    first_result_at: Optional[float] = None
    finished_at: Optional[float] = None
    progress: List[dict] = dataclasses.field(default_factory=list)
    result: Optional[dict] = None
    error: Optional[str] = None
    # runtime.errors.classify kind of the failure ("poison_row",
    # "lane_failed", "fatal", ...) — the honest-status field /w/jobs
    # payloads surface so clients can tell "your spec is poison" (4xx)
    # from "the fleet broke" (5xx)
    error_kind: Optional[str] = None
    exc: Optional[BaseException] = None
    cancel_requested: bool = False
    batch_id: Optional[str] = None
    # obs spine: run_id is minted at ADMISSION (the earliest moment the
    # work exists) and joins this job's flight-recorder events, spans,
    # checkpoint manifests and metrics samples; attribution is the
    # per-tenant counter slice filled in by the scheduler at batch
    # boundaries (obs.batch_attribution)
    run_id: str = ""
    attribution: Optional[dict] = None
    done_event: threading.Event = dataclasses.field(
        default_factory=threading.Event
    )

    def __post_init__(self):
        if not self.id:
            self.seq = next(_JOB_SEQ)
            self.id = f"job-{self.seq:06d}"
        if not self.run_id:
            from ..obs import new_run_id

            self.run_id = new_run_id("job")

    def finish(self, state: JobState, *, result=None, error=None,
               error_kind=None, exc=None):
        self.state = state
        self.result = result
        self.error = error
        self.error_kind = error_kind
        self.exc = exc
        self.finished_at = time.monotonic()
        if self.first_result_at is None and state is JobState.DONE:
            self.first_result_at = self.finished_at
        self.done_event.set()

    def to_dict(self) -> dict:
        """Status payload (GET /w/jobs/{id}); results are served by the
        result endpoint so status stays small."""
        out = {
            "id": self.id,
            "runId": self.run_id,
            "state": self.state.value,
            "kind": self.kind,
            "priority": self.priority,
            "compat": self.compat,
            "batchId": self.batch_id,
            "progress": self.progress,
            "cancelRequested": self.cancel_requested,
        }
        if self.spec is not None:
            out["protocol"] = self.spec.protocol
            out["simMs"] = self.spec.sim_ms
            out["chunkMs"] = self.spec.chunk_ms
            out["seed"] = self.spec.seed
            out["tenant"] = self.spec.tenant
        if self.attribution is not None:
            out["attribution"] = self.attribution
        if self.error:
            out["error"] = self.error
        if self.error_kind:
            out["errorKind"] = self.error_kind
        return out


# ---------------------------------------------------------------------------
# queue


class JobQueue:
    """Bounded pending list + full job registry.

    The bound covers PENDING jobs only — completed records stay
    addressable for result pickup (bounded by ``keep_done``, FIFO
    pruned).  All mutation happens under one lock; ``wait_for_work``
    parks the scheduler worker on the condition variable."""

    def __init__(self, max_depth: int = 64, keep_done: int = 512):
        if max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        self.max_depth = max_depth
        self.keep_done = keep_done
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._pending: List[Job] = []
        self._jobs: Dict[str, Job] = {}
        self._done_order: List[str] = []
        self.rejected_total = 0

    # -- admission -----------------------------------------------------

    def submit(self, job: Job, retry_after_s: int = 1) -> Job:
        with self._lock:
            if len(self._pending) >= self.max_depth:
                self.rejected_total += 1
                raise QueueFullError(len(self._pending), retry_after_s)
            job.submitted_at = time.monotonic()
            self._pending.append(job)
            self._jobs[job.id] = job
            self._work.notify_all()
        return job

    # -- lookup --------------------------------------------------------

    def get(self, job_id: str) -> Job:
        with self._lock:
            job = self._jobs.get(job_id)
        if job is None:
            raise UnknownJobError(f"no such job {job_id!r}")
        return job

    def depth(self) -> int:
        with self._lock:
            return len(self._pending)

    def depth_for(self, compat: str) -> int:
        """Pending jobs of one compatibility family — the per-family
        Retry-After pacing reads this instead of the global depth, so a
        slow family's backlog doesn't inflate a fast family's hint."""
        with self._lock:
            return sum(1 for j in self._pending if j.compat == compat)

    def jobs(self) -> List[Job]:
        with self._lock:
            return list(self._jobs.values())

    # -- scheduler interface -------------------------------------------

    def pending_snapshot(self) -> List[Job]:
        """Read-only copy of the pending list (batch planning / scheduler
        contract checks — nothing is removed)."""
        with self._lock:
            return list(self._pending)

    def best_pending(self) -> Optional[Job]:
        """Highest-priority, oldest pending job (no removal)."""
        with self._lock:
            if not self._pending:
                return None
            return max(self._pending, key=lambda j: (j.priority, -j.seq))

    def has_higher_priority(self, priority: int) -> bool:
        with self._lock:
            return any(j.priority > priority for j in self._pending)

    def take_batch(self, compat: str, max_n: int) -> List[Job]:
        """Remove and return up to ``max_n`` pending jobs sharing
        ``compat``, in FIFO order — the scheduler packs these onto one
        replica axis."""
        with self._lock:
            picked: List[Job] = []
            rest: List[Job] = []
            for j in self._pending:
                if j.compat == compat and len(picked) < max_n:
                    picked.append(j)
                else:
                    rest.append(j)
            self._pending = rest
            return picked

    def requeue(self, jobs: List[Job]) -> None:
        """Return jobs to the pending list (front, preserving seq order)
        — used when a dispatch is abandoned before running."""
        with self._lock:
            self._pending = sorted(
                jobs + self._pending, key=lambda j: j.seq
            )
            self._work.notify_all()

    def wait_for_work(self, timeout: float = 1.0) -> bool:
        with self._lock:
            if self._pending:
                return True
            return self._work.wait(timeout)

    def notify(self) -> None:
        with self._lock:
            self._work.notify_all()

    # -- lifecycle -----------------------------------------------------

    def cancel(self, job_id: str):
        """Cancel a job: queued jobs cancel immediately; running jobs
        get the flag and are dropped at their batch boundary (device
        batches are not interrupted mid-program).  Returns
        (job, cancelled_now) — False when the job was already running
        (flag set) or already terminal (no-op)."""
        job = self.get(job_id)
        with self._lock:
            if job in self._pending:
                self._pending.remove(job)
                job.finish(JobState.CANCELLED)
                return job, True
            if job.state not in TERMINAL:
                job.cancel_requested = True
        return job, False

    def retire(self, job: Job) -> None:
        """Record a terminal job for result pickup, pruning the oldest
        terminal records past ``keep_done``."""
        with self._lock:
            self._done_order.append(job.id)
            while len(self._done_order) > self.keep_done:
                old = self._done_order.pop(0)
                self._jobs.pop(old, None)
