"""The batching scheduler: compatible jobs share one program,
compatibility families share the machine through lanes.

Ported from the JAX package's serve/scheduler.py, method for method.

Grouping discipline
-------------------
Two jobs may ride the same ``run_ms_batched`` dispatch iff they resolve
to the same **scenario family**: protocol name + every traced param
(anything not in the serve registry's ``state_only`` set) + execution
geometry.  For a direct (single device call) job the geometry is the
simulation horizon; for a chunked job it is the CHUNK UNIT only — the
horizon itself is per-job data ("horizon sharding"): a job's total
sim_ms is split at admission into fixed-length units
(``jobs.chunk_schedule``), so tenants with different horizons pack into
the same replica-axis batches and finish at their own chunk boundaries
instead of fragmenting into per-horizon programs.  That pre-key is
computed at admission from the spec alone; when the family is first
built, the full static digest is extended with
``runtime.supervisor.stable_run_key`` over the engine + template leaf
signature — the same digest the durable executor stamps into
checkpoints.  Everything else a job carries — seed, FaultPlan,
state-only params — is per-replica DATA.

One program per family
----------------------
Every dispatch is padded to a fixed replica capacity
(``max_batch_replicas``; padding rows are template copies whose results
are discarded), so every batch of a family presents the identical input
leaf signature to the run cache (parallel.replica_shard): ONE program
per (family, unit) however the workload arrives, which the run cache's
monotonic counters show.  (A quantum remainder costs one extra 1-row
program per distinct remainder length, and done-row harvesting one per
smaller capacity bucket.)  Families hold ONE engine object each on
purpose: ``net.cache_key()`` includes ``id(protocol)``/``id(latency)``,
so rebuilding the engine per job would defeat the cache.

Lanes
-----
The scheduler runs G dispatch lanes (``device_groups``), each a worker
thread bound to a device group (parallel.device_groups).  A family is
STICKY to the lane that first dispatches it.  Claiming (queue pops,
parked-batch resumes, family→lane binding) is serialized under one
dispatch lock; device execution happens outside it.  With the default
``device_groups=1`` there is one lane and no explicit placement.

Preemption
----------
A chunked batch runs through ``runtime.Supervisor`` in slices of
``slice_chunks`` device calls, checkpointing every chunk via
``engine/checkpoint.CheckpointManager``.  Between slices its lane
checks the queue: claimable work with strictly higher priority parks
the batch (its checkpoint is the park ticket) and runs first; the
parked batch later resumes from the checkpoint, bit-identical to an
uninterrupted run.  Slices also stop exactly at every member job's
horizon boundary, where the finished rows are captured and finalized
while the rest of the batch keeps running.  The chunk function goes
through the SAME run cache.

Design differences from the JAX package
---------------------------------------
- ``BatchScheduler(device=None)``: the families are built on CUDA unless
  the caller asks for the CPU (``engine.core.resolve_device``).
- ``state_digest`` gives the JAX package's hex string for the same
  state: its key paths as the JAX package renders them, words as
  uint32, the same bytes — so a served row can be checked across the
  packages.
- A program is the run cache's first call at a new input geometry
  (parallel.replica_shard); the port has no compile store, so
  ``health()["compileStore"]`` is ``{"enabled": False, "counters": {}}``.
- A lane with a device group has families of its own, built on its
  group's first device (the family key gains the lane);
  `run_singleton` builds on the scheduler's device.  A
  lane of several devices runs its batches placed on its group's layout
  (parallel.mesh2d); the results are gathered to the lane's first
  device to finish the jobs.  Families are always fault-armed, so a
  ``node_parallel > 1`` lane raises when it runs a batch until the node
  axis takes fault-armed engines (ROADMAP Queue A 2).
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import shutil
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..engine.core import map_state, resolve_device, stack_states
from ..faults.plan import lower_plans
from ..obs import (
    FlightRecorder,
    InvariantSentinel,
    SLOEngine,
    TraceContext,
    batch_attribution,
    default_serve_specs,
    get_recorder,
    load_capacity_table,
    mint_context,
)
from ..obs.attribution import host
from ..parallel.device_groups import make_device_groups, visible_devices
from ..parallel.mesh2d import PlacedState
from ..parallel.replica_shard import (
    _run_and_reduce,
    run_cache_info,
    sharded_run_stats,
)
from ..runtime.errors import (
    taxonomy_counters,
    RETRYABLE_KINDS,
    LaneFailedError,
    PoisonRowError,
    classify,
)
from ..runtime.locks import lock_trace_status, make_lock, yield_point
from ..runtime.policy import SalvagePolicy
from ..runtime.supervisor import (
    Supervisor,
    iter_leaves,
    leaf_signature,
    stable_run_key,
)
from ..telemetry import TelemetryConfig
from ..telemetry.export import counters, progress_series
from .jobs import (
    DrainingError,
    Job,
    JobQueue,
    JobSpec,
    JobState,
    QueueFullError,
    chunk_schedule,
    serve_protocol,
)
from .metrics import ServeMetrics


def _unplaced(state):
    """A lane's result on one device: a placed state gathered to its
    first cell's device, anything else as it is."""
    return state.gather() if isinstance(state, PlacedState) else state


def _job_ctx(job: Job) -> TraceContext:
    """The admission-minted identity of a job as a TraceContext."""
    return TraceContext(
        run_id=job.run_id,
        job_id=job.id,
        tenant_id=job.spec.tenant if job.spec is not None else None,
    )


def _leaf_signature(state) -> tuple:
    """path:shape:dtype per leaf — rows packed together must agree
    exactly or the stacked program would differ from the family's."""
    return tuple(leaf_signature(state))


def state_digest(state) -> str:
    """Bitwise identity of a state (side-cars included): blake2b over
    every leaf's path, dtype, shape, and raw bytes, in the JAX package's
    order and rendering (words as uint32), so the hex string equals the
    JAX package's for the same state.  Two runs are 'the same result'
    iff these match — the multi-tenant correctness contract (batched row
    == singleton run) is checked on this."""
    h = hashlib.blake2b(digest_size=16)
    for path, leaf, word in iter_leaves(state):
        arr = np.asarray(host(leaf))  # 0-d leaves stay 0-d
        if word:
            arr = arr.view(np.uint32)
        h.update(path.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


class ScenarioFamily:
    """One compatibility class: a single engine object + per-params
    single-replica templates, all sharing one traced program.

    ``mode`` is "direct" (one device call per batch, horizon traced
    into the program) or "chunked" (``unit_ms`` steps through the
    Supervisor; horizons are per-job data)."""

    def __init__(self, key, digest, net, entry, tele_cfg, sim_ms, chunk_ms,
                 base_params_key, base_template, mode="direct",
                 unit_ms=None):
        self.key = key  # admission-time pre-key
        self.digest = digest  # full static digest (stable_run_key suffix)
        self.net = net
        self.entry = entry
        self.tele_cfg = tele_cfg
        self.sim_ms = sim_ms  # first-seen horizon (informational only)
        self.chunk_ms = chunk_ms
        self.mode = mode
        self.unit_ms = unit_ms if unit_ms is not None else (chunk_ms or sim_ms)
        self.templates: Dict[str, object] = {base_params_key: base_template}
        self.signature = _leaf_signature(base_template)


class _Lane:
    """One dispatch lane: a worker thread bound to a device group (or,
    for the single-lane scheduler, to no explicit placement at all)."""

    def __init__(self, index: int, group=None):
        self.index = index
        self.group = group  # parallel.device_groups.DeviceGroup | None
        self.thread: Optional[threading.Thread] = None
        self.busy = False
        self.dispatches = 0
        self.busy_seconds = 0.0
        # supervision state: a lane thread that dies (exception or
        # injected kill) is restarted by _on_lane_failure; fail_streak
        # paces the restart backoff and resets on the next clean claim
        self.restarts = 0
        self.fail_streak = 0
        self.kill_requested = False
        self.abandoned = False
        # trace ids of the batch this lane last dispatched: when the
        # worker thread dies, the lane-failure alert names the victim
        # run instead of an anonymous lane index
        self.last_ctx: Optional[TraceContext] = None

    def alive(self) -> bool:
        return self.thread is not None and self.thread.is_alive()

    def describe(self) -> dict:
        return {
            "index": self.index,
            "devices": (
                [str(d) for d in self.group.devices]
                if self.group is not None
                else None
            ),
            "busy": self.busy,
            "dispatches": self.dispatches,
            "busySeconds": round(self.busy_seconds, 4),
            "alive": self.alive(),
            "restarts": self.restarts,
        }


class _ParkedBatch:
    """A chunked batch between slices: the Supervisor (whose checkpoint
    directory is the resume ticket) plus the jobs riding it.  With
    horizon sharding the member jobs may have different chunk counts
    (``job_chunks``); each job's row is captured and finalized at its
    own boundary while the batch runs on to the longest horizon."""

    def __init__(self, batch_id, family, jobs, supervisor, ckpt_dir,
                 priority, capacity, lane=0, job_chunks=None,
                 job_rems=None):
        self.batch_id = batch_id
        self.family = family
        self.jobs = jobs
        self.supervisor = supervisor
        self.ckpt_dir = ckpt_dir
        self.priority = priority
        self.capacity = capacity
        self.lane = lane
        self.job_chunks = job_chunks or []
        self.job_rems = job_rems or [0] * len(jobs)
        self.chunks_done = 0
        self.finished: set = set()  # job ids finalized at a boundary
        self.preempted = False
        self.running = False  # claimed by a lane this instant
        self.started = time.monotonic()


class BatchScheduler:
    """Queue consumer: groups, packs, dispatches, streams progress.

    ``device_groups`` lanes each run one worker thread (wave packing);
    the default of 1 is the legacy single-worker scheduler (the engine
    is replica-parallel, not request-parallel, within a lane).  HTTP
    handlers only touch the queue and job records.  ``auto_start=False``
    leaves the workers off so tests can drive ``drain_once()``
    deterministically (lane 0 unless told otherwise)."""

    def __init__(
        self,
        queue: Optional[JobQueue] = None,
        metrics: Optional[ServeMetrics] = None,
        *,
        max_batch_replicas: int = 8,
        slice_chunks: int = 2,
        telemetry_snapshots: int = 32,
        checkpoint_root: Optional[str] = None,
        auto_start: bool = True,
        recorder: Optional[FlightRecorder] = None,
        device_groups: int = 1,
        node_parallel: int = 1,
        horizon_quantum_ms: int = 0,
        binding_ttl_s: float = 300.0,
        salvage: Optional[SalvagePolicy] = None,
        lane_restart_limit: int = 0,
        harvest: bool = True,
        device=None,
    ):
        if max_batch_replicas < 1:
            raise ValueError(
                f"max_batch_replicas must be >= 1, got {max_batch_replicas}"
            )
        if horizon_quantum_ms < 0:
            raise ValueError(
                f"horizon_quantum_ms must be >= 0, got {horizon_quantum_ms}"
            )
        # the device the families are built on: CUDA unless asked
        self.device = resolve_device(device)
        self.queue = queue or JobQueue()
        self.metrics = metrics or ServeMetrics()
        self.max_batch_replicas = max_batch_replicas
        self.slice_chunks = max(1, slice_chunks)
        self.telemetry_snapshots = telemetry_snapshots
        self.horizon_quantum_ms = horizon_quantum_ms
        self.checkpoint_root = checkpoint_root or os.path.join(
            tempfile.gettempdir(), f"witt_serve_ckpt_{os.getpid()}"
        )
        self.auto_start = auto_start
        # flight recorder: admission / packing / dispatch decisions land
        # here alongside the supervisor's chunk events (one ring per
        # process by default, see obs.get_recorder)
        self.recorder = recorder if recorder is not None else get_recorder()
        self._families: Dict[str, ScenarioFamily] = {}
        self._fam_lock = make_lock("serve.family")
        self._parked: List[_ParkedBatch] = []
        self._batch_seq = 0
        # Retry-After pacing: per-family EMA of batch wall time (a slow
        # Handel family must not inflate a fast p2pflood tenant's
        # backoff hint) with the global EMA as the cold-family fallback
        self._ema_batch_s = 1.0
        self._ema_family: Dict[str, float] = {}
        # wave packing: lane list + the dispatch lock that serializes
        # every claim decision (queue pops, parked resumes, family→lane
        # binding); device execution runs outside it
        if device_groups < 1:
            raise ValueError(
                f"device_groups must be >= 1, got {device_groups}"
            )
        if node_parallel < 1:
            raise ValueError(
                f"node_parallel must be >= 1, got {node_parallel}"
            )
        if device_groups == 1 and node_parallel == 1:
            # no explicit placement: bit-for-bit the legacy scheduler
            # (and no re-placement cost for the common case)
            self._lanes = [_Lane(0, None)]
        else:
            groups = make_device_groups(
                device_groups, devices=visible_devices(self.device.type),
                node_parallel=node_parallel,
            )
            self._lanes = [_Lane(g.index, g) for g in groups]
        self.device_groups = len(self._lanes)
        self.node_parallel = node_parallel
        self._dispatch_lock = make_lock("serve.dispatch")
        self._family_lane: Dict[str, int] = {}
        self._active_dispatches = 0
        self._worker_lock = make_lock("serve.worker")
        self._stop = threading.Event()
        # -- fleet resilience ------------------------------------------
        # sticky bindings expire once a family has had no queued work
        # and no parked batch for this long (<= 0: expire immediately
        # when idle): the family's programs stay in the run cache
        # either way — expiry only re-decides the LANE, so a dead family
        # stops pinning lane choice forever.
        self.binding_ttl_s = binding_ttl_s
        self._binding_used: Dict[str, float] = {}
        # batch salvage: a failed packed batch is bisected to isolate
        # the poison row instead of failing every rider (runtime.policy)
        self.salvage = salvage if salvage is not None else SalvagePolicy()
        # 0 = restart crashed lanes forever; > 0 = abandon after N
        self.lane_restart_limit = lane_restart_limit
        # done-row harvesting: after members finalize at their horizon
        # boundaries, compact the survivors into the next-smaller
        # power-of-two capacity bucket and re-park, so a mostly-finished
        # batch stops re-running its dead width every slice.
        # Bitwise-neutral per row (replica rows are independent);
        # default-ON as in the JAX package
        self.harvest = bool(harvest)
        # graceful drain: admission refuses, lanes stop claiming,
        # in-flight chunked slices checkpoint-stop (Supervisor
        # should_stop); pending + parked work survives for undrain
        self._draining = threading.Event()
        # chaos hook (tests): called with
        # (family, jobs) immediately before EVERY device run — batch
        # dispatches and salvage probes alike — so an injected poison
        # fails exactly the subsets containing it and bisection can
        # isolate it.  run_singleton never calls it: reference results
        # stay fault-free.
        self.chaos_injector: Optional[Callable] = None
        # mission control: burn-rate SLOs over the metrics history
        # (obs/slo.py).  Evaluation is pull-driven — health(),
        # slo_status(), and the metrics each evaluate, so any poller keeps
        # the alert state fresh; alerts edge-trigger typed
        # flight-recorder events under the victim sample's run_id.
        self.slo = SLOEngine(
            self.metrics.timeseries,
            default_serve_specs(),
            recorder=self.recorder,
        )
        # runtime invariant sentinel input: the CAPACITY.json sizing
        # promises, loaded once (a fresh sentinel per chunked batch
        # keeps the per-invariant alert latch per-run)
        self._capacity_table = load_capacity_table()

    # -- admission -----------------------------------------------------

    def _schedule_for(self, spec: JobSpec) -> List[int]:
        return chunk_schedule(
            spec.sim_ms, spec.chunk_ms, self.horizon_quantum_ms
        )

    def _is_chunked(self, spec: JobSpec) -> bool:
        """Chunked execution: explicit chunkMs, or the scheduler
        quantum covers this horizon (sim_ms == quantum is one unit of
        the SHARED chunked family, not a private direct program)."""
        return bool(spec.chunk_ms) or (
            self.horizon_quantum_ms > 0
            and spec.sim_ms >= self.horizon_quantum_ms
        )

    def pre_key(self, spec: JobSpec) -> str:
        """Compatibility pre-key from the spec alone (no engine build):
        protocol + traced params + execution geometry + telemetry
        config.  Chunked jobs key on the chunk UNIT, not the horizon —
        horizon sharding packs mixed-simMs tenants into one family.
        Jobs sharing the pre-key are CANDIDATES for one batch; the
        family build extends it with the template leaf signature."""
        entry = serve_protocol(spec.protocol)
        traced = {
            k: spec.params[k]
            for k in sorted(spec.params)
            if k not in entry.state_only
        }
        schedule = self._schedule_for(spec)
        chunked = self._is_chunked(spec)
        horizon = (
            {"mode": "chunked", "unit_ms": schedule[0]}
            if chunked
            else {"mode": "direct", "sim_ms": spec.sim_ms}
        )
        payload = json.dumps(
            {
                "protocol": spec.protocol,
                "traced": traced,
                "snapshots": self.telemetry_snapshots,
                **horizon,
            },
            sort_keys=True,
            default=str,
        )
        return "fam-" + hashlib.blake2b(
            payload.encode(), digest_size=8
        ).hexdigest()

    def retry_after_s(self, compat: Optional[str] = None) -> int:
        """Seconds until queued work likely drains one batch slot (RFC
        9110: >= 1).  With a known family the estimate is paced from
        THAT family's batch-time EMA over THAT family's backlog; the
        global EMA over the whole queue is the cold/unknown fallback."""
        if compat is not None and compat in self._ema_family:
            ema = self._ema_family[compat]
            depth = self.queue.depth_for(compat)
        else:
            ema = self._ema_batch_s
            depth = self.queue.depth()
        batches_ahead = depth // self.max_batch_replicas + 1
        # families drain concurrently across lanes: the wait shortens by
        # the wave width the fleet can actually sustain
        lanes = max(1, self.device_groups)
        return max(1, int(batches_ahead * ema / lanes + 0.5))

    def _note_batch_time(self, compat: Optional[str], dt: float) -> None:
        # lanes finish batches concurrently: the EMA read-modify-write
        # must not interleave
        with self._dispatch_lock:
            self._ema_batch_s = 0.5 * self._ema_batch_s + 0.5 * dt
            if compat:
                prev = self._ema_family.get(compat)
                self._ema_family[compat] = (
                    dt if prev is None else 0.5 * prev + 0.5 * dt
                )

    def submit(self, spec_dict: dict) -> Job:
        """Parse, validate, and enqueue one job (raises ValueError /
        KeyError on a malformed spec, QueueFullError on backpressure).
        This is where the job's run_id is minted (Job.__post_init__) —
        the first flight-recorder event of the run is its admission.
        While draining, admission refuses with DrainingError (the HTTP
        layer maps it to 503 + Retry-After)."""
        self._check_admission()
        spec = JobSpec.from_dict(spec_dict)
        job = Job(spec=spec, compat=self.pre_key(spec),
                  priority=spec.priority)
        try:
            self.queue.submit(
                job, retry_after_s=self.retry_after_s(job.compat)
            )
        except QueueFullError as e:
            self.recorder.record(
                "admission-rejected", ctx=_job_ctx(job),
                protocol=spec.protocol, depth=e.depth,
                retry_after_s=e.retry_after_s,
            )
            raise
        self.recorder.record(
            "admission", ctx=_job_ctx(job),
            protocol=spec.protocol, compat=job.compat,
            sim_ms=spec.sim_ms, chunk_ms=spec.chunk_ms or None,
            schedule_units=len(self._schedule_for(spec)),
            priority=spec.priority or None,
            queue_depth=self.queue.depth(),
        )
        self.metrics.observe_submit()
        if self.auto_start:
            self.start()
        return job

    def submit_legacy(self, thunk, priority: int = 0) -> Job:
        """Queue an opaque host-side thunk: it occupies one lane turn and
        is never packed with batch jobs."""
        self._check_admission()
        job = Job(spec=None, compat="", kind="legacy", thunk=thunk,
                  priority=priority)
        job.compat = f"legacy-{job.id}"
        self.queue.submit(job, retry_after_s=self.retry_after_s())
        self.metrics.observe_submit()
        if self.auto_start:
            self.start()
        return job

    def cancel(self, job_id: str) -> Job:
        job, cancelled_now = self.queue.cancel(job_id)
        if cancelled_now:
            self.metrics.observe_job(job)
            self.queue.retire(job)
        return job

    # -- families ------------------------------------------------------

    @staticmethod
    def _params_key(params: dict) -> str:
        return json.dumps(params, sort_keys=True, default=str)

    def _lane_device(self, lane) -> torch.device:
        """Where a lane's families live: its group's first device (the
        scheduler's without a group)."""
        if lane is None or lane.group is None:
            return self.device
        return lane.group.devices[0]

    def family_for(self, spec: JobSpec, lane=None) -> ScenarioFamily:
        """The family of `spec` for `lane`: a lane with a device group
        has families of its own, built on its group's first device."""
        dev = self._lane_device(lane)
        key = self.pre_key(spec)
        if lane is not None and lane.group is not None:
            key = f"{key}@lane{lane.index}"
        with self._fam_lock:
            fam = self._families.get(key)
            if fam is not None:
                return fam
            schedule = self._schedule_for(spec)
            chunked = self._is_chunked(spec)
            unit = schedule[0]
            snaps = self.telemetry_snapshots
            # snapshot cadence must derive from the family's traced
            # geometry: the chunk UNIT for chunked families (whose
            # members disagree on sim_ms), the horizon for direct ones
            cadence_ms = unit if chunked else spec.sim_ms
            tele_cfg = TelemetryConfig(
                snapshots=snaps,
                snapshot_every_ms=max(1, cadence_ms // max(1, snaps)),
            )
            entry = serve_protocol(spec.protocol)
            net, state = entry.build(spec.params, tele_cfg, dev)
            # faults are ALWAYS armed: a fault-free job is the neutral
            # schedule (bit-identical to the fault-free run), so one
            # program serves faulted and clean rows alike
            net, state = net.with_faults(state)
            # chunked families span horizons, so the digest carries the
            # unit (n_chunks=0 marks "variable"); direct families keep
            # the single-call geometry
            digest = key + "/" + stable_run_key(
                net, state, 0 if chunked else 1,
                unit if chunked else spec.sim_ms,
            )
            fam = ScenarioFamily(
                key, digest, net, entry, tele_cfg, spec.sim_ms,
                unit if chunked else 0, self._params_key(spec.params),
                state, mode="chunked" if chunked else "direct",
                unit_ms=unit,
            )
            self._families[key] = fam
            return fam

    def _template_for(self, fam: ScenarioFamily, spec: JobSpec):
        pk = self._params_key(spec.params)
        st = fam.templates.get(pk)
        if st is not None:
            return st
        # params differ only in state-only fields (same pre-key): build
        # the layout with a throwaway engine, arm side-cars through the
        # FAMILY net so the signature discipline is identical, and keep
        # only the state
        _, st = fam.entry.build(spec.params, fam.tele_cfg, fam.net.device)
        _, st = fam.net.with_faults(st)
        if _leaf_signature(st) != fam.signature:
            raise ValueError(
                f"params {spec.params} change the traced program despite "
                f"matching family {fam.key} — state-only contract "
                "violation"
            )
        fam.templates[pk] = st
        return st

    def _row(self, fam: ScenarioFamily, spec: JobSpec):
        st = self._template_for(fam, spec)
        # seed is per-replica data; `*0 +` keeps the leaf dtype exact
        return st._replace(seed=st.seed * 0 + spec.seed)

    def _pack(self, fam: ScenarioFamily, jobs: List[Job]):
        """Stack job rows + padding to the fixed replica capacity and
        attach the per-row fault schedules.  The padding rows are the
        base template (results discarded): every batch of a family has
        the identical leaf signature -> one program, ever."""
        base = next(iter(fam.templates.values()))
        rows = [self._row(fam, j.spec) for j in jobs]
        rows += [base] * (self.max_batch_replicas - len(rows))
        stacked = stack_states(rows)
        plans = [j.spec.plan for j in jobs]
        plans += [None] * (self.max_batch_replicas - len(plans))
        fs = lower_plans(
            plans, fam.net.n_nodes, fam.net.protocol.n_msg_types(),
            device=fam.net.device,
        )
        return stacked._replace(faults=fs)

    # -- results -------------------------------------------------------

    def _row_result(self, fam: ScenarioFamily, row) -> dict:
        return {
            "digest": state_digest(row),
            "time": int(row.time),
            "counters": counters(fam.net, row),
            "progress": progress_series(row),
        }

    def run_singleton(self, spec_dict: dict) -> dict:
        """Reference result for one spec: a 1-row stack through the
        engine directly (no packing, no run cache).  The multi-tenant
        contract is that every batched job's result digest equals this
        — replica rows of a batched run are independent.  A chunked or
        horizon-sharded spec replays the SAME chunk schedule
        (jobs.chunk_schedule — one source of truth with the batched
        path): the sim state is schedule-independent, but the telemetry
        loop census (jumps cannot cross a chunk boundary) is part of
        the digested side-car."""
        spec = JobSpec.from_dict(spec_dict)
        fam = self.family_for(spec)
        row = self._row(fam, spec)
        stacked = stack_states([row])
        fs = lower_plans(
            [spec.plan], fam.net.n_nodes, fam.net.protocol.n_msg_types(),
            device=fam.net.device,
        )
        out = stacked._replace(faults=fs)
        for step in self._schedule_for(spec):
            out = fam.net.run_ms_batched(out, step)
        single = map_state(lambda a: a[0], out)
        return self._row_result(fam, single)

    # -- planning ------------------------------------------------------

    def plan_batches(self) -> List[dict]:
        """Group the pending queue into dispatch plans WITHOUT removing
        or running anything: highest-priority-first, FIFO within a
        family, capped at the replica capacity.  Every plan's jobs share
        one compat key by construction."""
        remaining = sorted(
            self.queue.pending_snapshot(),
            key=lambda j: (-j.priority, j.seq),
        )
        plans = []
        while remaining:
            head = remaining[0]
            same = [j for j in remaining if j.compat == head.compat]
            take = same[: self.max_batch_replicas]
            taken = set(id(j) for j in take)
            remaining = [j for j in remaining if id(j) not in taken]
            plans.append(
                {
                    "compat": head.compat,
                    "priority": head.priority,
                    "jobs": [j.id for j in take],
                    "kind": head.kind,
                }
            )
        return plans

    # -- dispatch ------------------------------------------------------

    def _lane_obj(self, lane: Optional[int]) -> _Lane:
        return self._lanes[0 if lane is None else lane]

    def _claimable_pending(self, lane_idx: int) -> Optional[Job]:
        """Best pending job this lane may run: legacy thunks run
        anywhere; batch jobs only where their family is (or can be)
        bound.  Caller holds the dispatch lock."""
        best = None
        for j in self.queue.pending_snapshot():
            bound = self._family_lane.get(j.compat)
            if j.kind != "legacy" and bound is not None and bound != lane_idx:
                continue
            if best is None or (j.priority, -j.seq) > (
                best.priority, -best.seq
            ):
                best = j
        return best

    def _claim(self, lane: _Lane):
        """One scheduling decision for one lane, under the dispatch
        lock: resume this lane's best parked batch or pop the best
        claimable pending group (binding its family to the lane).
        Returns ("parked", batch) | ("legacy", job) | ("jobs", jobs) |
        None.  While draining nothing is claimable: pending jobs stay
        queued and parked batches stay checkpoint-parked."""
        if self._draining.is_set():
            return None
        yield_point("serve.claim")
        with self._dispatch_lock:
            parked = max(
                (
                    b
                    for b in self._parked
                    if not b.running and b.lane == lane.index
                ),
                key=lambda b: (b.priority, -b.started),
                default=None,
            )
            best = self._claimable_pending(lane.index)
            if parked is not None and (
                best is None or best.priority <= parked.priority
            ):
                parked.running = True
                self._binding_used[parked.family.key] = time.monotonic()
                self._mark_busy(lane)
                return ("parked", parked)
            if best is None:
                return None
            if parked is not None and best.priority > parked.priority:
                if not parked.preempted:
                    parked.preempted = True
                    self.metrics.observe_preemption()
            jobs = self.queue.take_batch(
                best.compat,
                1 if best.kind == "legacy" else self.max_batch_replicas,
            )
            if not jobs:
                return None
            if best.kind == "legacy":
                self._mark_busy(lane)
                return ("legacy", jobs[0])
            # sticky family→lane binding: placement is part of the
            # program's input signature, so a family that wandered
            # across lanes would cost one program per lane
            self._family_lane.setdefault(best.compat, lane.index)
            self._binding_used[best.compat] = time.monotonic()
            self._mark_busy(lane)
            return ("jobs", jobs)

    def _mark_busy(self, lane: _Lane) -> None:
        """Caller holds the dispatch lock.  Wave width = lanes busy the
        instant this dispatch starts (this lane included)."""
        lane.busy = True
        lane.dispatches += 1
        self._active_dispatches += 1
        width = sum(1 for l in self._lanes if l.busy)
        self.metrics.observe_wave(lane.index, width)

    def _mark_idle(self, lane: _Lane, t0: float) -> None:
        with self._dispatch_lock:
            lane.busy = False
            lane.busy_seconds += time.monotonic() - t0
            self._active_dispatches -= 1

    def drain_once(self, lane: Optional[int] = None) -> bool:
        """One scheduling decision on one lane (default: lane 0 — the
        deterministic entry point tests drive; each lane's worker loop
        calls this with its own index).  Returns False when this lane
        has nothing claimable."""
        lane_obj = self._lane_obj(lane)
        claim = self._claim(lane_obj)
        if claim is None:
            return False
        kind, item = claim
        t0 = time.monotonic()
        try:
            if kind == "parked":
                return self._continue_parked(item)
            if kind == "legacy":
                self._run_legacy(item)
                return True
            self._dispatch(item, lane_obj)
            return True
        finally:
            self._mark_idle(lane_obj, t0)

    def _finish_job(self, job: Job, state: JobState, **kw) -> None:
        job.finish(state, **kw)
        self.metrics.observe_job(job)
        self.queue.retire(job)

    def _run_legacy(self, job: Job) -> None:
        job.state = JobState.RUNNING
        job.started_at = time.monotonic()
        if job.cancel_requested:
            self._finish_job(job, JobState.CANCELLED)
            return
        try:
            result = job.thunk()
        except BaseException as e:  # noqa: BLE001 — surfaced to waiter
            self._finish_job(
                job, JobState.FAILED,
                error=f"{type(e).__name__}: {e}", exc=e,
            )
            return
        self._finish_job(job, JobState.DONE, result=result)

    def _dispatch(self, jobs: List[Job], lane: _Lane) -> None:
        yield_point("serve.dispatch")
        live = []
        for j in jobs:
            if j.cancel_requested:
                self._finish_job(j, JobState.CANCELLED)
            else:
                live.append(j)
        if not live:
            return
        # scheduler contract: one batch, one digest
        compat = {j.compat for j in live}
        if len(compat) != 1:
            raise RuntimeError(
                f"batch mixes compatibility keys {sorted(compat)}"
            )
        try:
            fam = self.family_for(live[0].spec, lane)
        except BaseException as e:  # noqa: BLE001 — family build failure
            # the family comes from the shared pre-key, so no single
            # job can be blamed: the whole group fails honestly
            for j in live:
                self._finish_job(
                    j, JobState.FAILED,
                    error=f"{type(e).__name__}: {e}",
                    error_kind=classify(e), exc=e,
                )
            return
        # per-row blast-radius control: a job whose OWN row fails to
        # build (bad state-only params, a state-only violation) is quarantined
        # alone instead of failing every rider in the batch
        ok = []
        for j in live:
            try:
                self._row(fam, j.spec)
            except BaseException as e:  # noqa: BLE001 — poison row build
                self._quarantine(j, e, phase="row-build")
            else:
                ok.append(j)
        live = ok
        if not live:
            return
        try:
            stacked = self._pack(fam, live)
        except BaseException as e:  # noqa: BLE001 — pack failure
            for j in live:
                self._finish_job(
                    j, JobState.FAILED,
                    error=f"{type(e).__name__}: {e}",
                    error_kind=classify(e), exc=e,
                )
            return
        with self._dispatch_lock:
            self._batch_seq += 1
            batch_id = f"batch-{self._batch_seq:05d}"
            wave_width = sum(1 for l in self._lanes if l.busy)
        now = time.monotonic()
        for j in live:
            j.state = JobState.RUNNING
            j.started_at = now
            j.batch_id = batch_id
        # the batch gets its own run identity (it IS the device run);
        # the pack event records the join batch run_id <-> member job
        # run_ids, so obs_query can walk from any job to its chunks
        batch_ctx = mint_context("batch")
        if lane is not None:
            lane.last_ctx = batch_ctx
        self.recorder.record(
            "pack", ctx=batch_ctx, batch_id=batch_id,
            compat=live[0].compat, family_digest=fam.digest,
            mode=fam.mode,
            lane=lane.index,
            wave_width=wave_width,
            members=[
                {
                    "job_id": j.id,
                    "run_id": j.run_id,
                    "tenant": j.spec.tenant,
                    "replica": i,
                    "sim_ms": j.spec.sim_ms,
                }
                for i, j in enumerate(live)
            ],
            live_rows=len(live),
            padding_rows=self.max_batch_replicas - len(live),
            capacity=self.max_batch_replicas,
        )
        if fam.mode == "chunked":
            self._start_chunked(
                batch_id, fam, live, stacked, batch_ctx, lane
            )
        else:
            self._dispatch_direct(
                batch_id, fam, live, stacked, batch_ctx, lane
            )

    def _dispatch_direct(
        self, batch_id, fam, jobs, stacked, ctx=None, lane=None
    ) -> None:
        if lane is not None and lane.group is not None:
            # commit the batch to this lane's devices: wave packing's
            # concurrency comes from different lanes running on
            # disjoint device groups; with a 2D lane the engine hands
            # place() the node-column classification
            stacked = lane.group.place(stacked, net=fam.net)
        t0 = time.monotonic()
        try:
            self._chaos_check(fam, jobs)
            out, _stats = sharded_run_stats(fam.net, stacked, fam.sim_ms)
            self._finalize(fam, jobs, out)
        except BaseException as e:  # noqa: BLE001 — device failure
            self.recorder.record(
                "batch-failed", ctx=ctx, batch_id=batch_id,
                error=f"{type(e).__name__}: {e}"[:500],
            )
            self._salvage_batch(
                fam, jobs, self._direct_salvage_runner(fam, lane),
                batch_id, ctx, e,
            )
            return
        finally:
            dt = time.monotonic() - t0
            self._note_batch_time(jobs[0].compat if jobs else None, dt)
            self.metrics.observe_batch(
                len(jobs), self.max_batch_replicas, dt
            )

    def _row_watch(self, fam: ScenarioFamily, jobs: List[Job]):
        """Done-row census callback for the Supervisor's per-chunk sync
        (runtime.supervisor row_watch): counts member rows whose
        protocol all_done already holds — the observability signal the
        harvesting lever is judged by.  Reads the already-synced state
        only; never feeds back into the sim."""
        proto = fam.net.protocol
        n_live = len(jobs)

        def watch(state, chunk):
            done = host(proto.all_done(_unplaced(state)))
            self.metrics.observe_rows_done(
                int(done[:n_live].sum()), n_live
            )

        return watch

    def _build_supervisor(
        self, batch_id, fam, jobs, stacked, capacity, n_chunks,
        ckpt_dir, ctx, lane,
    ):
        """One chunked-batch Supervisor (shared by the pack path and
        done-row harvesting, which re-parks survivors under a smaller
        capacity).  The chunk function goes through the run cache:
        chunked mode costs ONE program per family geometry, not one per
        slice."""
        unit = fam.unit_ms
        cached = _run_and_reduce(fam.net, unit)
        placement = (
            (lambda s, _g=lane.group, _n=fam.net: _g.place(s, net=_n))
            if lane is not None and lane.group is not None
            else None
        )
        # a fresh sentinel per batch: the per-invariant alert latch is
        # per-run, and its violations alert through the scheduler's SLO
        # engine (typed event + witt_obs_alerts_total) naming this
        # batch's run_id
        sentinel = InvariantSentinel(
            net=fam.net,
            capacity_table=self._capacity_table,
            engine=self.slo,
        )
        return Supervisor(
            lambda s: cached(s)[0],
            stacked,
            n_chunks=n_chunks,
            chunk_ms=unit,
            checkpoint_dir=ckpt_dir,
            checkpoint_every=1,
            run_key=stable_run_key(fam.net, stacked, n_chunks, unit),
            max_chunks_this_run=self.slice_chunks,
            ctx=ctx,
            recorder=self.recorder,
            placement=placement,
            timeseries=self.metrics.timeseries,
            sentinel=sentinel,
            row_watch=self._row_watch(fam, jobs),
            # graceful drain: an in-flight slice stops at its next
            # chunk boundary (checkpoint on disk), batch stays parked
            should_stop=self._draining.is_set,
            run_meta={
                "batch_id": batch_id,
                "capacity": capacity,
                "members": [
                    {"job_id": j.id, "run_id": j.run_id,
                     "tenant": j.spec.tenant}
                    for j in jobs
                ],
            },
        )

    def _start_chunked(
        self, batch_id, fam, jobs, stacked, ctx=None, lane=None
    ) -> None:
        unit = fam.unit_ms
        # horizon sharding: every member advances in the same fixed
        # units; its OWN chunk count (and quantum remainder) decides
        # when its row is captured
        job_chunks = [max(1, j.spec.sim_ms // unit) for j in jobs]
        job_rems = [
            j.spec.sim_ms % unit if j.spec.sim_ms > unit else 0
            for j in jobs
        ]
        n_chunks = max(job_chunks)
        ckpt_dir = os.path.join(self.checkpoint_root, batch_id)
        sup = self._build_supervisor(
            batch_id, fam, jobs, stacked, self.max_batch_replicas,
            n_chunks, ckpt_dir, ctx, lane,
        )
        parked = _ParkedBatch(
            batch_id, fam, jobs, sup, ckpt_dir,
            max(j.priority for j in jobs), self.max_batch_replicas,
            lane=lane.index if lane is not None else 0,
            job_chunks=job_chunks, job_rems=job_rems,
        )
        parked.running = True
        with self._dispatch_lock:
            self._parked.append(parked)
        self._continue_parked(parked)

    def _continue_parked(self, parked: _ParkedBatch) -> bool:
        try:
            if parked.preempted:
                parked.preempted = False
                self.metrics.observe_resume()
            if all(j.cancel_requested for j in parked.jobs):
                for j in parked.jobs:
                    if j.id not in parked.finished:
                        self._finish_job(j, JobState.CANCELLED)
                self._drop_parked(parked)
                return True
            # stop exactly at the next member horizon boundary (where
            # finished rows are captured) without exceeding the
            # preemption slice
            next_boundary = min(
                (c for c in parked.job_chunks if c > parked.chunks_done),
                default=parked.supervisor.n_chunks,
            )
            parked.supervisor.max_chunks_this_run = min(
                self.slice_chunks, next_boundary - parked.chunks_done
            )
            t0 = time.monotonic()
            try:
                self._chaos_check(parked.family, parked.jobs)
                report = parked.supervisor.run()
            except BaseException as e:  # noqa: BLE001 — supervised failure
                # the supervisor already recorded + dumped its black
                # box; this event marks the batch-level consequence
                self.recorder.record(
                    "batch-failed", ctx=parked.supervisor.ctx,
                    batch_id=parked.batch_id,
                    error=f"{type(e).__name__}: {e}"[:500],
                )
                survivors = [
                    j for j in parked.jobs if j.id not in parked.finished
                ]
                lane = self._lanes[parked.lane]
                self._drop_parked(parked)
                self._salvage_batch(
                    parked.family, survivors,
                    self._chunked_salvage_runner(parked.family, lane),
                    parked.batch_id, parked.supervisor.ctx, e,
                )
                return True
            dt = time.monotonic() - t0
            self._note_batch_time(parked.family.key, dt)
            self.metrics.observe_batch(
                len(parked.jobs), parked.capacity, dt
            )
            parked.chunks_done = report.chunks_done
            self._stream_progress(parked, report.state)
            self._capture_finished(parked, report.state)
            if report.ok or len(parked.finished) == len(parked.jobs):
                self._drop_parked(parked)
            elif self.harvest:
                # survivors may now fit a smaller capacity bucket: the
                # per-chunk sync already materialized report.state on
                # host, so compaction costs one gather, not a sync
                self._maybe_harvest(parked, report.state)
            # otherwise: a controlled partial stop — the batch stays
            # parked (checkpoint on disk) and this lane's next
            # drain_once decides whether it continues or yields to
            # higher-priority work
            return True
        finally:
            parked.running = False

    def _harvest_bucket(self, survivors: int, capacity: int,
                        lane: _Lane) -> Optional[int]:
        """Smallest power-of-two replica width that (a) holds the
        survivors, (b) divides evenly over the lane's devices when one
        is placed, and (c) is strictly smaller than the current
        capacity — None when compaction buys nothing."""
        b = 1
        while b < survivors:
            b <<= 1
        if lane is not None and lane.group is not None:
            nd = len(lane.group.devices)
            while b < nd or b % nd:
                b <<= 1
        return b if b < capacity else None

    def _maybe_harvest(self, parked: _ParkedBatch, stacked) -> None:
        """Done-row harvesting: compact the survivors of a
        partially-finished parked batch into the next-smaller capacity
        bucket and re-park them under a fresh Supervisor, so later
        slices stop re-running rows that already finalized at their
        horizon boundary.

        Per-row bitwise identity is the salvage-bisection argument:
        replica rows are independent, so a survivor's row carried (one
        gather, no recompute) into a narrower stack continues its exact
        singleton stream; chunk boundaries are unchanged (the rebased
        supervisor still steps the same fixed units), and the padding
        rows duplicate a survivor (results discarded, like _pack's
        base-template rows).  The narrower width is ONE new input
        geometry inside the family's existing run-cache entry: one
        program, ever."""
        yield_point("serve.harvest")
        surv = [
            i for i, j in enumerate(parked.jobs)
            if j.id not in parked.finished
        ]
        if not surv:
            return
        lane = self._lanes[parked.lane]
        bucket = self._harvest_bucket(len(surv), parked.capacity, lane)
        if bucket is None:
            return
        idx = torch.tensor(
            surv + [surv[0]] * (bucket - len(surv)), dtype=torch.long,
            device=stacked.time.device,
        )
        compacted = map_state(lambda a: a[idx], stacked)
        jobs = [parked.jobs[i] for i in surv]
        job_chunks = [
            parked.job_chunks[i] - parked.chunks_done for i in surv
        ]
        job_rems = [parked.job_rems[i] for i in surv]
        batch_id = f"{parked.batch_id}-h{bucket}"
        ckpt_dir = os.path.join(self.checkpoint_root, batch_id)
        ctx = mint_context("batch")
        try:
            sup = self._build_supervisor(
                batch_id, parked.family, jobs, compacted, bucket,
                max(job_chunks), ckpt_dir, ctx, lane,
            )
        except BaseException as e:  # noqa: BLE001 — keep the wide batch
            # harvesting is an optimization: on any failure the batch
            # stays parked at its current width and resumes as before
            self.recorder.record(
                "harvest-failed", ctx=ctx, batch_id=parked.batch_id,
                error=f"{type(e).__name__}: {e}"[:500],
            )
            return
        fresh = _ParkedBatch(
            batch_id, parked.family, jobs, sup, ckpt_dir,
            max(j.priority for j in jobs), bucket, lane=parked.lane,
            job_chunks=job_chunks, job_rems=job_rems,
        )
        fresh.preempted = parked.preempted
        for j in jobs:
            j.batch_id = batch_id
        self.recorder.record(
            "harvest", ctx=ctx, batch_id=parked.batch_id,
            harvested_batch_id=batch_id,
            survivors=len(surv),
            capacity_before=parked.capacity, capacity_after=bucket,
            chunks_done=parked.chunks_done,
            members=[
                {"job_id": j.id, "run_id": j.run_id} for j in jobs
            ],
        )
        with self._dispatch_lock:
            if parked in self._parked:
                self._parked.remove(parked)
            self._parked.append(fresh)
        shutil.rmtree(parked.ckpt_dir, ignore_errors=True)
        self.metrics.observe_harvest(parked.capacity - bucket, ctx=ctx)

    def _capture_finished(self, parked: _ParkedBatch, stacked) -> None:
        """Finalize every member whose horizon boundary is the current
        chunk count: capture its row from the batch state, run any
        quantum remainder on a 1-row stack (the singleton replays the
        identical [unit]*k + [rem] schedule), and finish the job while
        the batch runs on for longer-horizon members."""
        fam = parked.family
        finishing = [
            i
            for i, c in enumerate(parked.job_chunks)
            if c == parked.chunks_done
            and parked.jobs[i].id not in parked.finished
        ]
        if not finishing:
            return
        attrib = self._attribution(fam, parked.jobs, stacked)
        for i in finishing:
            job = parked.jobs[i]
            parked.finished.add(job.id)
            if job.cancel_requested:
                self._finish_job(job, JobState.CANCELLED)
                continue
            rem = parked.job_rems[i]
            try:
                if rem:
                    row = self._run_remainder(fam, stacked, i, rem)
                else:
                    row = map_state(lambda a, i=i: a[i], stacked)
                result = self._row_result(fam, row)
            except BaseException as e:  # noqa: BLE001 — row finalization
                self._finish_job(
                    job, JobState.FAILED,
                    error=f"{type(e).__name__}: {e}", exc=e,
                )
                continue
            job.progress = result["progress"]
            if attrib is not None:
                job.attribution = self._job_attribution(attrib, job)
                result["attribution"] = job.attribution
                self.metrics.observe_tenant(
                    job.spec.tenant, attrib["jobs"].get(job.id)
                )
            self._finish_job(job, JobState.DONE, result=result)

    def _run_remainder(self, fam: ScenarioFamily, stacked, i: int,
                       rem_ms: int):
        """A quantum remainder (sim_ms % unit) for one captured row: a
        1-row stack through the run cache — the tail of the same chunk
        schedule the singleton replays.  Costs one small program per
        distinct remainder length."""
        row1 = map_state(lambda a, i=i: a[i: i + 1], stacked)
        out, _stats = _run_and_reduce(fam.net, rem_ms)(row1)
        return map_state(lambda a: a[0], out)

    def _stream_progress(self, parked: _ParkedBatch, stacked) -> None:
        # live per-tenant attribution at the slice boundary: the job
        # shows who is consuming the batch while it runs, not only at
        # the end
        attrib = self._attribution(parked.family, parked.jobs, stacked)
        for i, job in enumerate(parked.jobs):
            if job.state is not JobState.RUNNING:
                continue
            if attrib is not None:
                job.attribution = self._job_attribution(attrib, job)
            series = progress_series(stacked, replica=i)
            if series:
                job.progress = series
                self.metrics.observe_ttfr(job)

    def _drop_parked(self, parked: _ParkedBatch) -> None:
        with self._dispatch_lock:
            if parked in self._parked:
                self._parked.remove(parked)
        shutil.rmtree(parked.ckpt_dir, ignore_errors=True)

    # -- attribution ----------------------------------------------------

    def _attribution(self, fam, jobs: List[Job], out) -> Optional[dict]:
        """Per-tenant counter slice of a packed batch (obs module);
        read-only over the final state, never affects the result
        digests."""
        try:
            return batch_attribution(
                fam.net,
                out,
                [
                    {"job_id": j.id, "run_id": j.run_id,
                     "tenant": j.spec.tenant}
                    for j in jobs
                ],
                self.max_batch_replicas,
            )
        except (TypeError, ValueError, AttributeError):
            return None  # attribution must never fail a batch

    @staticmethod
    def _job_attribution(attrib: dict, job: Job) -> dict:
        """The one-job status view: this job's row slice, its tenant's
        aggregate, and the batch totals they reconcile against."""
        return {
            "job": attrib["jobs"].get(job.id),
            "tenant": attrib["tenants"].get(job.spec.tenant),
            "batch": attrib["batch"],
        }

    def _finalize(self, fam: ScenarioFamily, jobs: List[Job], out) -> None:
        out = _unplaced(out)
        attrib = self._attribution(fam, jobs, out)
        for i, job in enumerate(jobs):
            if job.cancel_requested:
                self._finish_job(job, JobState.CANCELLED)
                continue
            row = map_state(lambda a, i=i: a[i], out)
            result = self._row_result(fam, row)
            job.progress = result["progress"]
            if attrib is not None:
                job.attribution = self._job_attribution(attrib, job)
                result["attribution"] = job.attribution
                self.metrics.observe_tenant(
                    job.spec.tenant, attrib["jobs"].get(job.id)
                )
            self._finish_job(job, JobState.DONE, result=result)

    # -- poison quarantine + batch salvage ------------------------------

    def _chaos_check(self, fam: ScenarioFamily, jobs: List[Job]) -> None:
        if self.chaos_injector is not None:
            self.chaos_injector(fam, jobs)

    def _quarantine(self, job: Job, cause: BaseException,
                    phase: str = "salvage") -> None:
        """Terminal 4xx-style disposition: this job's OWN row breaks the
        batch, so it must never be packed (or retried) again."""
        perr = PoisonRowError(job.id, cause)
        kind = classify(perr)
        self.recorder.record(
            "quarantine", ctx=_job_ctx(job), job_id=job.id,
            batch_id=job.batch_id, phase=phase,
            error=str(perr)[:300],
        )
        self._finish_job(
            job, JobState.QUARANTINED,
            error=str(perr), error_kind=kind, exc=perr,
        )

    def _direct_salvage_runner(self, fam: ScenarioFamily, lane=None):
        """Re-run a subset of a failed direct batch.  Padding to the
        SAME replica capacity keeps the leaf signature identical, so a
        probe is a run-cache hit on the family's one program; replica
        row independence makes each survivor's result bitwise identical
        to its singleton."""
        def run(subset: List[Job]) -> None:
            stacked = self._pack(fam, subset)
            if lane is not None and lane.group is not None:
                stacked = lane.group.place(stacked, net=fam.net)
            self._chaos_check(fam, subset)
            out, _stats = sharded_run_stats(fam.net, stacked, fam.sim_ms)
            self._finalize(fam, subset, out)

        return run

    def _chunked_salvage_runner(self, fam: ScenarioFamily, lane=None):
        """Re-run a subset of a failed chunked batch from chunk 0,
        replaying the shared unit schedule (jobs.chunk_schedule) and
        capturing each row at its own horizon boundary — the identical
        schedule the singleton replays, so survivors stay bitwise."""
        unit = fam.unit_ms

        def run(subset: List[Job]) -> None:
            job_chunks = [
                max(1, j.spec.sim_ms // unit) for j in subset
            ]
            job_rems = [
                j.spec.sim_ms % unit if j.spec.sim_ms > unit else 0
                for j in subset
            ]
            stacked = self._pack(fam, subset)
            if lane is not None and lane.group is not None:
                stacked = lane.group.place(stacked, net=fam.net)
            self._chaos_check(fam, subset)
            cached = _run_and_reduce(fam.net, unit)
            rows = {}
            for step in range(1, max(job_chunks) + 1):
                stacked = cached(stacked)[0]
                for i, j in enumerate(subset):
                    if job_chunks[i] != step:
                        continue
                    rem = job_rems[i]
                    rows[j.id] = (
                        self._run_remainder(fam, stacked, i, rem)
                        if rem
                        else map_state(lambda a, i=i: a[i], stacked)
                    )
            attrib = self._attribution(fam, subset, stacked)
            for j in subset:
                if j.cancel_requested:
                    self._finish_job(j, JobState.CANCELLED)
                    continue
                result = self._row_result(fam, rows[j.id])
                j.progress = result["progress"]
                if attrib is not None:
                    j.attribution = self._job_attribution(attrib, j)
                    result["attribution"] = j.attribution
                    self.metrics.observe_tenant(
                        j.spec.tenant, attrib["jobs"].get(j.id)
                    )
                self._finish_job(j, JobState.DONE, result=result)

        return run

    def _salvage_batch(self, fam: ScenarioFamily, jobs: List[Job],
                       runner, batch_id, ctx,
                       error: BaseException) -> None:
        """Bisect a failed batch to isolate the poison row(s).

        A passing probe's results are KEPT (same program, rows
        independent → bitwise identical to singletons);
        a failing probe splits in half; a failing singleton probe is the
        poison and is QUARANTINED — unless its failure classifies as
        retryable (transient/device_lost), where blaming the job would
        be dishonest, so it FAILS with the taxonomy kind instead.  When
        the probe budget (SalvagePolicy.max_probe_runs) runs out,
        unresolved rows FAIL with the original batch error rather than
        guess."""
        err_s = f"{type(error).__name__}: {error}"
        if not self.salvage.enabled:
            for j in jobs:
                self._finish_job(
                    j, JobState.FAILED, error=err_s,
                    error_kind=classify(error), exc=error,
                )
            return
        t0 = time.monotonic()
        self.recorder.record(
            "salvage-start", ctx=ctx, batch_id=batch_id,
            rows=len(jobs), error=err_s[:300],
        )
        runs = 0
        quarantined: List[tuple] = []
        failed: List[tuple] = []

        def probe(subset: List[Job]) -> None:
            nonlocal runs
            if runs >= self.salvage.max_probe_runs:
                failed.extend((j, error) for j in subset)
                return
            runs += 1
            try:
                runner(subset)  # finalizes DONE/CANCELLED on success
            except BaseException as e:  # noqa: BLE001 — probe failure
                self.recorder.record(
                    "salvage-run", ctx=ctx, batch_id=batch_id,
                    rows=len(subset), ok=False,
                    error=f"{type(e).__name__}: {e}"[:300],
                )
                if len(subset) == 1:
                    if classify(e) in RETRYABLE_KINDS:
                        failed.append((subset[0], e))
                    else:
                        quarantined.append((subset[0], e))
                    return
                mid = len(subset) // 2
                probe(subset[:mid])
                probe(subset[mid:])
            else:
                self.recorder.record(
                    "salvage-run", ctx=ctx, batch_id=batch_id,
                    rows=len(subset), ok=True,
                )

        if len(jobs) == 1:
            # singleton batch: one probe doubles as the transient retry
            probe(jobs)
        else:
            mid = len(jobs) // 2
            probe(jobs[:mid])
            probe(jobs[mid:])
        for j, cause in quarantined:
            if j.cancel_requested:
                self._finish_job(j, JobState.CANCELLED)
            else:
                self._quarantine(j, cause)
        for j, cause in failed:
            if j.cancel_requested:
                self._finish_job(j, JobState.CANCELLED)
                continue
            self._finish_job(
                j, JobState.FAILED,
                error=f"{type(cause).__name__}: {cause}",
                error_kind=classify(cause), exc=cause,
            )
        dt = time.monotonic() - t0
        self.metrics.observe_salvage(runs, dt)
        self.recorder.record(
            "salvage-done", ctx=ctx, batch_id=batch_id, runs=runs,
            seconds=round(dt, 4), quarantined=len(quarantined),
            failed=len(failed),
            salvaged=len(jobs) - len(quarantined) - len(failed),
        )

    # -- workers --------------------------------------------------------

    def start(self) -> None:
        # auto_start means every submit calls this: a burst of first
        # requests races the is_alive checks and, unguarded, each
        # spawns its own (identically named) workers — concurrent
        # workers on ONE lane then duplicate batch programs.  One
        # worker per lane is the design; the dispatch lock serializes
        # their claims.
        with self._worker_lock:
            self._stop.clear()
            for lane in self._lanes:
                # explicit (re)start is an operator action: it pardons
                # lanes abandoned at the restart limit
                lane.abandoned = False
                if lane.thread is not None and lane.thread.is_alive():
                    continue
                lane.thread = threading.Thread(
                    target=self._loop, args=(lane.index,), daemon=True,
                    name=f"witt-serve-lane-{lane.index}",
                )
                lane.thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self.queue.notify()
        with self._worker_lock:
            threads = [
                lane.thread
                for lane in self._lanes
                if lane.thread is not None
            ]
            for lane in self._lanes:
                lane.thread = None
        for t in threads:
            t.join(timeout)

    def _loop(self, lane_idx: int) -> None:
        lane = self._lanes[lane_idx]
        try:
            while not self._stop.is_set():
                if lane.kill_requested:
                    lane.kill_requested = False
                    raise LaneFailedError(lane_idx, "injected kill")
                if self.drain_once(lane_idx):
                    lane.fail_streak = 0
                else:
                    self._reap_bindings()
                    self.queue.wait_for_work(timeout=0.2)
        except BaseException as e:  # noqa: BLE001 — lane death
            if self._stop.is_set():
                return
            # per-job failures are reported on the jobs themselves; an
            # exception REACHING here killed the worker thread — treat
            # it as a lane failure: supervise, re-bind, restart
            self._on_lane_failure(lane, e)

    def inject_lane_failure(self, lane: int = 0) -> None:
        """Chaos hook: make the lane's worker raise LaneFailedError at
        its next loop iteration, exercising the REAL death → supervise →
        re-bind → restart path (a Python thread cannot be killed from
        outside, so the kill is cooperative but the recovery is not)."""
        self._lanes[lane].kill_requested = True
        self.queue.notify()

    def _on_lane_failure(self, lane: _Lane, exc: BaseException) -> None:
        """Fleet supervision, run on the dying thread as its last act:
        record and count the death, release any dispatch slot it held,
        re-bind its sticky families (and re-home its parked batches) to
        healthy lanes — or drop the bindings entirely in a single-lane
        fleet so the replacement worker re-binds on its next claim —
        then spawn the replacement with a crash-loop backoff."""
        yield_point("serve.lane-failure")
        kind = classify(exc)
        lane.fail_streak += 1
        victim = lane.last_ctx
        self.metrics.observe_lane_failure(ctx=victim)
        self.recorder.record(
            "lane-failed", ctx=victim, lane=lane.index, error_kind=kind,
            error=f"{type(exc).__name__}: {exc}"[:300],
            fail_streak=lane.fail_streak,
        )
        moved = []
        with self._dispatch_lock:
            if lane.busy:
                # died mid-dispatch bookkeeping: release the slot so
                # quiescence and wave-width stay truthful
                lane.busy = False
                self._active_dispatches = max(
                    0, self._active_dispatches - 1
                )
            healthy = [
                l for l in self._lanes
                if l is not lane and l.alive() and not l.abandoned
            ]
            if healthy:
                ring = itertools.cycle(healthy)
                for compat, idx in list(self._family_lane.items()):
                    if idx == lane.index:
                        tgt = next(ring).index
                        self._family_lane[compat] = tgt
                        moved.append((compat, tgt))
                for b in self._parked:
                    if b.lane == lane.index and not b.running:
                        b.lane = next(ring).index
            else:
                for compat, idx in list(self._family_lane.items()):
                    if idx == lane.index:
                        self._family_lane.pop(compat)
                        self._binding_used.pop(compat, None)
                        moved.append((compat, None))
        for compat, tgt in moved:
            self.metrics.observe_rebind()
            self.recorder.record(
                "family-rebound", compat=compat,
                from_lane=lane.index, to_lane=tgt,
            )
        self._restart_lane(lane)
        self.queue.notify()

    def _restart_lane(self, lane: _Lane) -> bool:
        if (
            self.lane_restart_limit
            and lane.restarts >= self.lane_restart_limit
        ):
            lane.abandoned = True
            self.recorder.record(
                "lane-abandoned", lane=lane.index,
                restarts=lane.restarts,
            )
            return False
        # crash-loop backoff paid by the dying thread — the rest of the
        # fleet keeps serving while this lane sits out
        time.sleep(min(1.0, 0.05 * lane.fail_streak))
        with self._worker_lock:
            if self._stop.is_set():
                return False
            lane.restarts += 1
            lane.thread = threading.Thread(
                target=self._loop, args=(lane.index,), daemon=True,
                name=f"witt-serve-lane-{lane.index}",
            )
            lane.thread.start()
        self.metrics.observe_lane_restart(ctx=lane.last_ctx)
        self.recorder.record(
            "lane-restart", ctx=lane.last_ctx, lane=lane.index,
            restarts=lane.restarts,
        )
        return True

    def _reap_bindings(self) -> None:
        """Expire sticky family→lane bindings that have had no queued
        job and no parked batch for ``binding_ttl_s`` (without expiry a
        retired family would pin its lane choice for the life of the
        process).  The family itself — and its programs in the run
        cache — survives; only the lane decision is re-opened."""
        now = time.monotonic()
        expired = []
        with self._dispatch_lock:
            if not self._family_lane:
                return
            pending = {j.compat for j in self.queue.pending_snapshot()}
            parked = {b.family.key for b in self._parked}
            for compat in list(self._family_lane):
                if compat in pending or compat in parked:
                    continue
                last = self._binding_used.get(compat)
                if last is None:
                    # bound before use-stamping existed: start the
                    # clock now instead of expiring on sight
                    self._binding_used[compat] = now
                    continue
                if now - last >= self.binding_ttl_s:
                    self._family_lane.pop(compat)
                    self._binding_used.pop(compat, None)
                    expired.append(compat)
        for compat in expired:
            self.metrics.observe_binding_expired()
            self.recorder.record("binding-expired", compat=compat)

    def busy(self) -> bool:
        with self._dispatch_lock:
            active = self._active_dispatches
        return bool(self._parked) or self.queue.depth() > 0 or active > 0

    def wait_idle(self, timeout: float = 60.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if not self.busy():
                return True
            time.sleep(0.02)
        return not self.busy()

    # -- graceful drain -------------------------------------------------

    def _check_admission(self) -> None:
        if self._draining.is_set():
            self.recorder.record("admission-rejected", reason="draining")
            raise DrainingError(self.retry_after_s())

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def drain(self) -> dict:
        """Enter graceful drain: admission refuses with DrainingError
        (HTTP 503 + Retry-After), lanes stop claiming, and in-flight
        chunked slices checkpoint-stop at their next chunk boundary
        (the Supervisor's should_stop hook).  Pending jobs stay QUEUED
        and parked batches keep their checkpoints: undrain() resumes
        both, bit-identical (the supervisor's replay contract).
        Idempotent; returns drain_status()."""
        if not self._draining.is_set():
            self._draining.set()
            self.metrics.observe_drain()
            self.recorder.record(
                "drain-start", queue_depth=self.queue.depth(),
                parked=len(self._parked),
            )
        self.queue.notify()
        return self.drain_status()

    def undrain(self) -> dict:
        if self._draining.is_set():
            self._draining.clear()
            self.recorder.record(
                "drain-end", queue_depth=self.queue.depth(),
                parked=len(self._parked),
            )
        if self.auto_start:
            self.start()
        self.queue.notify()
        return self.drain_status()

    def quiescent(self) -> bool:
        """True once a drain has settled: no lane is executing anything
        (parked batches are checkpoints on disk, pending jobs are inert
        in the queue) — safe to stop the process."""
        with self._dispatch_lock:
            active = self._active_dispatches
        return self._draining.is_set() and active == 0

    def drain_status(self) -> dict:
        with self._dispatch_lock:
            active = self._active_dispatches
            parked = len(self._parked)
            draining = self._draining.is_set()
        return {
            "draining": draining,
            "quiescent": draining and active == 0,
            "activeDispatches": active,
            "parkedBatches": parked,
            "queueDepth": self.queue.depth(),
            "retryAfterS": self.retry_after_s(),
        }

    # -- exposition ----------------------------------------------------

    def health(self) -> dict:
        """Operational snapshot (the JAX package's /w/health payload):
        queue pressure, per-lane liveness, drain state, resilience
        counters, run-cache and error-taxonomy state.  The port has no
        compile store: ``compileStore`` reports it disabled.
        Read-only."""
        with self._dispatch_lock:
            lanes = [lane.describe() for lane in self._lanes]
            active = self._active_dispatches
            parked = len(self._parked)
            bindings = len(self._family_lane)
            draining = self._draining.is_set()
        m = self.metrics
        # pull-driven SLO evaluation: every health poll refreshes the
        # burn-rate state (edge-triggered alerts fire here)
        self.slo.evaluate()
        lt = lock_trace_status()
        return {
            "queueDepth": self.queue.depth(),
            "queueCapacity": self.queue.max_depth,
            "draining": draining,
            "quiescent": draining and active == 0,
            "activeDispatches": active,
            "parkedBatches": parked,
            "families": len(self._families),
            "familyBindings": bindings,
            "lanes": lanes,
            "lanesAlive": sum(1 for d in lanes if d["alive"]),
            "laneFailuresTotal": m.lane_failures_total,
            "laneRestartsTotal": m.lane_restarts_total,
            "quarantinedTotal": m.jobs_quarantined,
            "salvageBatchesTotal": m.salvage_batches_total,
            "compileStore": {"enabled": False, "counters": {}},
            "runCache": run_cache_info(),
            "errorKinds": taxonomy_counters(),
            "alerts": self.slo.alert_counts(),
            "lockTrace": {
                k: lt[k]
                for k in ("armed", "maxWaitS", "waitP99S", "violationCount")
            },
        }

    def slo_status(self) -> dict:
        """The SLO payload: burn-rate rows per registered SLO,
        active (latched) alerts, alert counters, and the metric-history
        digest they are computed from.  Evaluating here means any
        poller keeps the alert state fresh (pull model — no evaluator
        thread to supervise)."""
        return self.slo.status(evaluate=True)

    def status(self) -> dict:
        return {
            "queueDepth": self.queue.depth(),
            "queueCapacity": self.queue.max_depth,
            "draining": self._draining.is_set(),
            "parkedBatches": len(self._parked),
            "families": len(self._families),
            "familyBindings": len(self._family_lane),
            "maxBatchReplicas": self.max_batch_replicas,
            "retryAfterS": self.retry_after_s(),
            "deviceGroups": self.device_groups,
            "nodeParallel": self.node_parallel,
            "horizonQuantumMs": self.horizon_quantum_ms,
            "lanes": [lane.describe() for lane in self._lanes],
            "waveWidthMax": self.metrics.wave_width_max,
        }

    def add_prometheus(self, p) -> None:
        self.metrics.add_prometheus(p, self.queue)
        self.slo.add_prometheus(p)
        lt = lock_trace_status()
        if lt["armed"]:
            for name, row in sorted(lt["perLock"].items()):
                p.add(
                    "runtime_lock_wait_seconds", row["waitSecondsTotal"],
                    "cumulative seconds spent waiting to acquire each "
                    "registered lock (WITT_LOCK_TRACE only)",
                    "counter", {"lock": name},
                )
            p.add(
                "runtime_lock_order_violations_total",
                lt["violationCount"],
                "distinct lock-order violations observed by TracedLock",
                "counter",
            )
        p.add(
            "serve_draining",
            1 if self._draining.is_set() else 0,
            "1 while the scheduler is in graceful drain",
            "gauge",
        )
        for kind, n in sorted(taxonomy_counters().items()):
            p.add(
                "runtime_error_kind_total", n,
                "classified failures by error-taxonomy kind",
                "counter", {"kind": kind},
            )
