"""Supervised chunked-run executor: the durable loop around run_ms.

The engine is deterministic in (state, tick count), so a chunked run is
bit-identical to a straight one for a tick-driven protocol (and to the
same chunk schedule for an event-driven one), which makes durability a
host-side concern.  The Supervisor wraps any chunk function (state ->
state, typically a `run_ms_batched` slice) in a loop

    resume -> [guard -> chunk -> sync -> checkpoint]* -> report

with:

- **checkpoint/resume** through engine.checkpoint.CheckpointManager:
  numbered checkpoints + LATEST pointer, run_key-stamped so a checkpoint
  of another run refuses to resume (ResumeMismatchError); kill-and-resume
  is bit-identical to an uninterrupted run, side-cars included, because
  the resume replays the exact remaining chunk schedule.  The files and
  the run key are the JAX package's, so a run checkpointed by either
  package resumes in the other;
- **watchdog**: each chunk executes on one persistent WatchdogWorker
  thread with a deadline (the first chunk of a process gets the compile
  allowance on top: the kernels build and load inside it), under the
  caller's grad and inference mode.  The sync that waits for the card
  runs inside the guarded call, so the deadline times the work, not the
  enqueue: a miss raises WatchdogTimeoutError.  Python cannot cancel a
  hung device call; killing the process is a process-level supervisor's
  job;
- **retry with backoff**: transient failures (classify()) replay
  deterministically from the last host anchor, a numpy copy of the state
  taken at checkpoint cadence, so retried chunks produce the exact bytes
  a clean run would have;
- **degradation** (opt-in): on device loss with
  DegradePolicy(cpu_fallback=True) the anchor is re-placed on the CPU
  and the run continues with `cpu_chunk_fn` (a chunk function of a
  network built on the CPU), with {degraded, degraded_at_chunk,
  platform: "cpu"} stamped into provenance;
- **budget/cap/stop partial stops**: checkpoint now, return
  RunReport(ok=False); the next invocation resumes where this one
  stopped;
- **observability**: a TraceContext (run_id / job_id / tenant_id) rides
  provenance, the checkpoint manifest's meta, tracer spans and the
  FlightRecorder events; a resume adopts the stored run_id, so the
  victim process and the resume process tell one story.  A
  TimeSeriesStore and an InvariantSentinel, when given, are fed at the
  per-chunk sync boundary; they read only the leaves they need and
  never fail the run.  On a failure that escapes the loop the recorder
  ring is dumped beside the checkpoints.

Everything here is host-side: the simulation state is bit-identical
with all of it armed.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from ..engine.checkpoint import CheckpointManager
from ..engine.core import SimState
from ..interop import is_word_leaf, protocol_of, state_from_numpy, state_to_numpy
from ..obs.attribution import host
from ..obs.context import TraceContext, mint_context
from ..protocols.ethpow_batched import EthPowState
from .errors import (
    RETRYABLE_KINDS,
    DurableRunError,
    FatalRunError,
    ResumeMismatchError,
    RetriesExhaustedError,
    WatchdogTimeoutError,
    classify,
)
from .policy import DegradePolicy, RetryPolicy, WatchdogPolicy, WatchdogWorker


# -- state trees --------------------------------------------------------


def _tensors(tree) -> list:
    """The tensor leaves of a state tree (SimState, EthPowState, dicts,
    sequences), in no promised order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _device_of(tree) -> torch.device:
    """The device of a state's tensors (the CPU for a tree of none)."""
    leaves = _tensors(tree)
    return leaves[0].device if leaves else torch.device("cpu")


def _sync(state: Any) -> None:
    """Ground-truth chunk completion: eager CUDA launches return before
    the card is done, so wait for the state's device.  Runs inside the
    deadline-guarded call, so the watchdog times the work."""
    dev = _device_of(state)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _HostState:
    """A SimState's or EthPowState's leaves as private numpy copies, in
    the JAX package's dtypes (`interop.state_to_numpy`)."""

    __slots__ = ("tree",)

    def __init__(self, tree):
        self.tree = tree


def _copy_host(tree):
    if isinstance(tree, dict):
        return {k: _copy_host(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and not tree:
        return tree
    return np.array(tree, copy=True)


def _to_host(tree):
    if isinstance(tree, (SimState, EthPowState)):
        return _HostState(_copy_host(state_to_numpy(tree)))
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not hasattr(tree, "_fields"):
        return type(tree)(_to_host(v) for v in tree)
    return np.array(host(tree), copy=True)


def _from_host(tree, device: torch.device):
    if isinstance(tree, _HostState):
        return state_from_numpy(tree.tree, device)
    if isinstance(tree, dict):
        return {k: _from_host(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_from_host(v, device) for v in tree)
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


# -- run identity -------------------------------------------------------


def _render_path(keys: tuple) -> str:
    """A key path as the JAX package's `str(path)` renders it."""
    if len(keys) == 1:
        return f"({keys[0]},)"
    return f"({', '.join(keys)})"


def _attr(name: str) -> str:
    return f"GetAttrKey(name={name!r})"


def _leaf_sig(keys: tuple, leaf, word: bool = False) -> str:
    shape = getattr(leaf, "shape", ())
    if isinstance(shape, torch.Size):
        shape = tuple(shape)
    dtype = getattr(leaf, "dtype", type(leaf).__name__)
    if isinstance(dtype, torch.dtype):
        dtype = str(dtype).replace("torch.", "")
        if word and dtype == "int32":
            dtype = "uint32"  # the JAX package's words
    return f"{_render_path(keys)}:{shape}:{dtype}"


def _signature(tree, keys: tuple = ()) -> List[str]:
    """`path:shape:dtype` of every leaf, in the JAX package's flattening
    order and rendering (engine/checkpoint._host_leaves' order), from the
    leaves' metadata only: no leaf's values are read."""
    if isinstance(tree, EthPowState):
        # a pytree class without key names in the JAX package
        return [_leaf_sig(keys + (f"FlattenedIndexKey(key={i})",), v)
                for i, v in enumerate(tree)]
    if isinstance(tree, SimState):
        protocol = protocol_of(tree.proto)
        out = []
        for f in SimState._fields:
            v = getattr(tree, f)
            if f == "proto":
                out += [_leaf_sig(keys + (_attr(f), f"DictKey(key={k!r})"), v[k],
                                  is_word_leaf(protocol, k)) for k in sorted(v)]
            else:
                out += _signature(v, keys + (_attr(f),))
        return out
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _signature(tree[k], keys + (f"DictKey(key={k!r})",))]
    if hasattr(tree, "_fields"):  # a NamedTuple side-car
        return [s for f in tree._fields for s in _signature(getattr(tree, f), keys + (_attr(f),))]
    if isinstance(tree, (tuple, list)):
        return [s for i, v in enumerate(tree) for s in _signature(v, keys + (f"SequenceKey(idx={i})",))]
    return [_leaf_sig(keys, tree)]


def stable_run_key(net: Any, template: Any, n_chunks: int, chunk_ms: int) -> str:
    """A run identity that survives process restarts: protocol type +
    chunk geometry + the template's leaf signature (paths, shapes and
    dtypes as the JAX package renders them, so both packages give the
    same key for the same run)."""
    proto = getattr(net, "protocol", net)
    digest = hashlib.blake2b(
        "|".join(_signature(template)).encode(), digest_size=8
    ).hexdigest()
    return f"{type(proto).__name__}:{n_chunks}x{chunk_ms}ms:{digest}"


def run_with_deadline(fn: Callable[[], Any], deadline_s: float, phase: str):
    """One-shot deadline guard over a WatchdogWorker: raises
    WatchdogTimeoutError(phase) on a miss; a completed call's worker is
    joined before returning."""
    worker = WatchdogWorker(name=f"witt-{phase}")
    try:
        return worker.call(fn, deadline_s, phase)
    finally:
        worker.close()


# per-chunk wall-time histogram buckets (seconds)
CHUNK_HIST_BUCKETS_S = (0.1, 0.5, 1.0, 2.0, 5.0, 10.0, 30.0, 60.0, 120.0)


def chunk_time_histogram(times: List[float]) -> dict:
    """Prometheus-style cumulative histogram of chunk wall-times:
    {"buckets": {"0.1": n, ..., "+Inf": n}, "count", "sum_s", "max_s"}."""
    buckets = {}
    for le in CHUNK_HIST_BUCKETS_S:
        buckets[str(le)] = sum(1 for t in times if t <= le)
    buckets["+Inf"] = len(times)
    return {
        "buckets": buckets,
        "count": len(times),
        "sum_s": round(sum(times), 4),
        "max_s": round(max(times), 4) if times else 0.0,
    }


@dataclass
class RunReport:
    """What a supervised run produced.  ok=False is a controlled partial
    stop (budget / chunk cap / stop request) with a checkpoint on disk;
    failures raise instead."""

    state: Any
    ok: bool
    chunk_seconds: List[float] = field(default_factory=list)
    provenance: dict = field(default_factory=dict)

    @property
    def chunks_done(self) -> int:
        return int(self.provenance.get("chunks_done", 0))


class Supervisor:
    """See module docstring.  `chunk_fn(state) -> state` advances one
    chunk; retries replay from the host anchor, never from the state the
    failed call was given."""

    def __init__(
        self,
        chunk_fn: Callable[[Any], Any],
        template: Any,
        *,
        n_chunks: int,
        chunk_ms: int = 0,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 1,
        keep: int = 3,
        retry: Optional[RetryPolicy] = None,
        watchdog: Optional[WatchdogPolicy] = None,
        degrade: Optional[DegradePolicy] = None,
        cpu_chunk_fn: Optional[Callable[[Any], Any]] = None,
        run_key: Optional[str] = None,
        run_meta: Optional[dict] = None,
        heartbeat: Optional[Callable[[int, float], None]] = None,
        budget_s: float = float("inf"),
        max_chunks_this_run: Optional[int] = None,
        should_stop: Optional[Callable[[], bool]] = None,
        sleep: Callable[[float], None] = time.sleep,
        consume_template: bool = False,
        tracer: Any = None,
        ctx: Optional[TraceContext] = None,
        recorder: Optional[FlightRecorder] = None,
        placement: Optional[Callable[[Any], Any]] = None,
        timeseries: Any = None,
        sentinel: Any = None,
        row_watch: Optional[Callable[[Any, int], None]] = None,
    ):
        if n_chunks < 1:
            raise ValueError(f"n_chunks must be >= 1, got {n_chunks}")
        if checkpoint_every < 1:
            raise ValueError(
                f"checkpoint_every must be >= 1, got {checkpoint_every}"
            )
        self.chunk_fn = chunk_fn
        self.template = template
        self.device = _device_of(template)
        self.n_chunks = n_chunks
        self.chunk_ms = chunk_ms
        self.manager = (
            CheckpointManager(checkpoint_dir, keep=keep)
            if checkpoint_dir
            else None
        )
        self.checkpoint_every = checkpoint_every
        self.retry = retry or RetryPolicy()
        self.watchdog = watchdog
        self.degrade = degrade
        self.cpu_chunk_fn = cpu_chunk_fn
        self.run_key = run_key
        self.run_meta = dict(run_meta or {})
        self.heartbeat = heartbeat
        self.budget_s = budget_s
        self.max_chunks_this_run = max_chunks_this_run
        # cooperative preemption: checked between chunks; True ->
        # checkpoint now and return a controlled partial stop
        self.should_stop = should_stop
        self.sleep = sleep
        self.consume_template = consume_template
        # optional telemetry.trace.SpanTracer: chunk spans and instants
        # for failed chunks and degradation
        self.tracer = tracer
        # minted at run() when neither the caller nor a checkpoint
        # supplies one (_resume adopts the stored run_id)
        self.ctx = ctx
        if recorder is None:
            # imported here: obs/recorder takes a runtime lock, so a
            # module-level import would cycle through runtime/__init__
            from ..obs.recorder import get_recorder

            recorder = get_recorder()
        self.recorder = recorder
        # optional placement of resumed/anchored host states (a device
        # group): called with the numpy leaves instead of the default
        # placement on the template's device, never when degraded
        self.placement = placement
        # an obs.TimeSeriesStore and an obs.InvariantSentinel fed at the
        # per-chunk sync boundary, and a done-row watcher called there;
        # they read only, and never fail the run
        self.timeseries = timeseries
        self.sentinel = sentinel
        self.row_watch = row_watch
        self._wd_worker: Optional[WatchdogWorker] = None
        self._first_call_done = False
        self._degraded = False

    # -- state placement ------------------------------------------------

    def _snapshot(self, state: Any):
        """Host anchor: a private numpy copy of every leaf."""
        return _to_host(state)

    def _place(self, host_state: Any) -> Any:
        if self._degraded:
            return _from_host(host_state, torch.device("cpu"))
        if self.placement is not None:
            # the host leaves as interop.state_to_numpy gives them, which
            # interop.state_from_numpy takes
            tree = host_state.tree if isinstance(host_state, _HostState) else host_state
            return self.placement(tree)
        return _from_host(host_state, self.device)

    # -- chunk execution ------------------------------------------------

    def _active_chunk_fn(self) -> Callable[[Any], Any]:
        if self._degraded and self.cpu_chunk_fn is not None:
            return self.cpu_chunk_fn
        return self.chunk_fn

    def _run_chunk(self, state: Any) -> Any:
        fn = self._active_chunk_fn()

        def call():
            out = fn(state)
            _sync(out)
            return out

        if self.watchdog is None:
            out = call()
            self._first_call_done = True
            return out
        deadline = self.watchdog.chunk_deadline_s
        phase = "chunk"
        if not self._first_call_done:
            deadline += self.watchdog.compile_deadline_s
            phase = "compile+chunk"
        # one persistent worker across chunks (closed at run() end); a
        # hung worker is discarded and replaced
        if self._wd_worker is None or self._wd_worker.hung:
            self._wd_worker = WatchdogWorker()
        out = self._wd_worker.call(call, deadline, phase)
        self._first_call_done = True
        return out

    def _close_watchdog(self) -> None:
        if self._wd_worker is not None:
            self._wd_worker.close()
            self._wd_worker = None

    # -- observability ---------------------------------------------------

    def _record(self, kind: str, chunk: Optional[int] = None, **fields) -> None:
        if self.recorder is None:
            return
        ctx = self.ctx
        if ctx is not None and chunk is not None:
            ctx = ctx.child(chunk_seq=chunk)
        elif chunk is not None:
            fields.setdefault("chunk_seq", chunk)
        self.recorder.record(kind, ctx=ctx, **fields)

    @staticmethod
    def _tick_hwms(state: Any) -> dict:
        """The telemetry loop counters and high-water marks for the
        chunk-end event: five small leaves read to the host."""
        tele = getattr(state, "tele", None)
        if tele is None or not hasattr(tele, "ticks"):
            return {}
        try:
            return {
                "ticks": int(host(tele.ticks).sum()),
                "jumps": int(host(tele.jumps).sum()),
                "jumped_ms": int(host(tele.jumped_ms).sum()),
                "wheel_fill_hwm": int(host(tele.wheel_fill_hwm).max()),
                "ovf_hwm": int(host(tele.ovf_hwm).max()),
            }
        except (TypeError, ValueError, AttributeError):
            return {}

    def _observe_chunk(self, state: Any, chunk: int, dt: float,
                       hwms: dict) -> None:
        """The monitors' hook at the per-chunk sync boundary: feed the
        time series and run the sentinel.  Monitoring must never fail
        the run it watches, so everything is swallowed."""
        ctx = (
            self.ctx.child(chunk_seq=chunk) if self.ctx is not None else None
        )
        if self.timeseries is not None:
            try:
                self.timeseries.observe(
                    "supervisor.chunk_seconds", dt, ctx=ctx
                )
                for key in ("wheel_fill_hwm", "ovf_hwm"):
                    if key in hwms:
                        self.timeseries.observe(
                            f"supervisor.{key}", float(hwms[key]), ctx=ctx
                        )
            except Exception:  # noqa: BLE001 — monitoring is best-effort
                pass
        if self.row_watch is not None:
            try:
                self.row_watch(state, chunk)
            except Exception:  # noqa: BLE001 — monitoring is best-effort
                pass
        if self.sentinel is not None:
            self.sentinel.check(
                state, ctx=ctx, chunk=chunk,
                members=self.run_meta.get("members"),
                capacity=self.run_meta.get("capacity"),
            )

    # -- resume ---------------------------------------------------------

    @property
    def _needs_anchor(self) -> bool:
        """Host anchors exist to replay retries and seed checkpoints;
        without either, skip them."""
        return self.manager is not None or self.retry.max_attempts > 1

    def _fresh(self):
        if self.consume_template:
            # hand the template straight to chunk_fn (the caller passed
            # a disposable state); anchoring, if needed, copies it first
            return self.template, 0, None, []
        return self._place(self._snapshot(self.template)), 0, None, []

    def _resume(self):
        """-> (device_state, start_chunk, resumed_from_step, prior_times)."""
        if self.manager is None:
            return self._fresh()
        got = self.manager.restore_latest(self.template)
        if got is None:
            return self._fresh()
        state, step, manifest = got
        meta = (manifest or {}).get("meta", {})
        saved_key = meta.get("run_key")
        if (
            self.run_key is not None
            and saved_key is not None
            and saved_key != self.run_key
        ):
            raise ResumeMismatchError(
                f"checkpoint step {step} in {self.manager.directory} "
                f"belongs to run {saved_key!r}, not {self.run_key!r} — "
                "point the supervisor at a fresh checkpoint_dir"
            )
        saved_chunk_ms = meta.get("chunk_ms")
        if (
            self.chunk_ms
            and saved_chunk_ms
            and int(saved_chunk_ms) != int(self.chunk_ms)
        ):
            raise ResumeMismatchError(
                f"checkpoint step {step} was written with "
                f"chunk_ms={saved_chunk_ms}, this run uses "
                f"chunk_ms={self.chunk_ms} — resume would change the "
                "chunk schedule and break bit-identity"
            )
        if step > self.n_chunks:
            raise ResumeMismatchError(
                f"checkpoint step {step} exceeds this run's "
                f"n_chunks={self.n_chunks}"
            )
        # adopt the checkpointed run identity: the run_id belongs to the
        # run, not the process, so a resume after SIGKILL keeps emitting
        # under the id the victim minted
        saved_run_id = meta.get("run_id")
        if saved_run_id:
            if self.ctx is None:
                self.ctx = TraceContext(
                    run_id=saved_run_id,
                    job_id=meta.get("job_id"),
                    tenant_id=meta.get("tenant_id"),
                )
            elif self.ctx.run_id != saved_run_id:
                self.ctx = self.ctx.child(run_id=saved_run_id)
        prior = list(meta.get("chunk_seconds", []))
        if self.timeseries is not None:
            try:
                # the manifest is the authority on the metric history
                self.timeseries.restore(meta.get("timeseries"))
            except Exception:  # noqa: BLE001 — monitoring is best-effort
                pass
        # the loaded state is already a fresh copy on the template's
        # device; re-place it only when a placement asks for another
        if self.placement is not None:
            state = self._place(self._snapshot(state))
        return state, step, step, prior

    def _save(self, state: Any, step: int, times_all: List[float]) -> None:
        meta = {
            **self.run_meta,
            "run_key": self.run_key,
            "chunk_ms": self.chunk_ms,
            "n_chunks": self.n_chunks,
            "chunks_done": step,
            "chunk_seconds": [round(t, 4) for t in times_all],
            "degraded": self._degraded,
        }
        if self.timeseries is not None:
            try:
                meta["timeseries"] = self.timeseries.snapshot()
            except Exception:  # noqa: BLE001 — monitoring is best-effort
                pass
        if self.ctx is not None:
            # trace ids into the manifest meta: the join key a resume
            # adopts
            meta.setdefault("run_id", self.ctx.run_id)
            if self.ctx.job_id is not None:
                meta.setdefault("job_id", self.ctx.job_id)
            if self.ctx.tenant_id is not None:
                meta.setdefault("tenant_id", self.ctx.tenant_id)
        self.manager.save(state, step, meta=meta)
        self._record("checkpoint", step=step, dir=self.manager.directory)

    def _degrade_to_cpu(self, exc: BaseException, chunk: int) -> None:
        if self.cpu_chunk_fn is None and self.device.type != "cpu":
            raise FatalRunError(
                f"device lost at chunk {chunk} and DegradePolicy(cpu_fallback=True) "
                "has no cpu_chunk_fn: a chunk function of a network built on the CPU "
                "is needed to continue there"
            ) from exc
        self._degraded = True
        self._first_call_done = False  # the CPU path gets its own allowance
        self._record("degraded", chunk=chunk, to="cpu")
        if self.tracer is not None:
            self.tracer.instant("degraded-to-cpu", chunk=chunk)

    # -- the loop -------------------------------------------------------

    def run(self) -> RunReport:
        state, start_chunk, resumed_from, prior_times = self._resume()
        if self.ctx is None:
            # no caller-minted context and no checkpoint to adopt from:
            # this supervisor is the run's entry point
            self.ctx = mint_context("run")
        if resumed_from is not None:
            self._record(
                "resume", step=resumed_from, run_key=self.run_key
            )
        anchor = self._snapshot(state) if self._needs_anchor else None
        anchor_chunk = start_chunk
        times: List[float] = []  # this run's completed chunks, in order
        i = start_chunk
        fail_streak = 0
        retries_total = 0
        watchdog_timeouts = 0
        checkpoints = 0
        degraded_at = None
        t_start = time.perf_counter()

        def provenance(done: int) -> dict:
            return {
                "platform": "gpu" if _device_of(state).type == "cuda" else "cpu",
                "degraded": self._degraded,
                "degraded_at_chunk": degraded_at,
                "resumed_from_step": resumed_from,
                "retries": retries_total,
                "watchdog_timeouts": watchdog_timeouts,
                "checkpoints": checkpoints,
                "run_key": self.run_key,
                "chunk_ms": self.chunk_ms,
                "n_chunks": self.n_chunks,
                "chunks_done": done,
                "chunk_time_hist": chunk_time_histogram(times),
                **(self.ctx.ids() if self.ctx is not None else {}),
            }

        try:
            while i < self.n_chunks:
                over_budget = time.perf_counter() - t_start > self.budget_s
                over_cap = (
                    self.max_chunks_this_run is not None
                    and len(times) >= self.max_chunks_this_run
                )
                stop_requested = (
                    self.should_stop is not None and self.should_stop()
                )
                if over_budget or over_cap or stop_requested:
                    # controlled partial stop: checkpoint now (even off
                    # cadence) and report
                    if self.manager is not None and i > anchor_chunk:
                        self._save(state, i, prior_times + times)
                        checkpoints += 1
                    self._record(
                        "partial-stop", chunk=i,
                        reason=(
                            "budget" if over_budget
                            else "chunk-cap" if over_cap
                            else "stop-requested"
                        ),
                        chunks_done=i,
                    )
                    return RunReport(
                        state, False, times, provenance(i)
                    )
                try:
                    self._record("chunk-start", chunk=i)
                    t1 = time.perf_counter()
                    state = self._run_chunk(state)
                    dt = time.perf_counter() - t1
                    hwms = self._tick_hwms(state)
                    self._record(
                        "chunk-end", chunk=i, seconds=round(dt, 4),
                        degraded=self._degraded or None,
                        **hwms,
                    )
                    self._observe_chunk(state, i, dt, hwms)
                    if self.tracer is not None:
                        self.tracer.add_span(
                            "chunk", self.tracer.now_us() - dt * 1e6, dt * 1e6,
                            chunk=i, degraded=self._degraded,
                        )
                except BaseException as e:  # noqa: BLE001 — classified below
                    kind = classify(e)
                    if isinstance(e, WatchdogTimeoutError):
                        watchdog_timeouts += 1
                        self._record(
                            "watchdog", chunk=i, phase=e.phase,
                            deadline_s=e.deadline_s,
                        )
                    if self.tracer is not None:
                        self.tracer.instant(
                            "chunk-failed", chunk=i, kind=kind,
                            error=type(e).__name__,
                        )
                    if kind not in RETRYABLE_KINDS:
                        # replaying a non-environmental failure reproduces it
                        raise
                    fail_streak += 1
                    retries_total += 1
                    if fail_streak >= self.retry.max_attempts:
                        raise RetriesExhaustedError(fail_streak, e) from e
                    if (
                        kind == "device_lost"
                        and self.degrade is not None
                        and self.degrade.cpu_fallback
                        and not self._degraded
                    ):
                        self._degrade_to_cpu(e, i)
                        degraded_at = i
                    delay = self.retry.delay_s(fail_streak - 1)
                    self._record(
                        "retry", chunk=i, error_kind=kind,
                        error=type(e).__name__, fail_streak=fail_streak,
                        delay_s=round(delay, 4), replay_from=anchor_chunk,
                    )
                    self.sleep(delay)
                    # replay deterministically from the last anchor: the
                    # chunks between anchor_chunk and i re-run and produce
                    # the exact bytes the failed timeline would have
                    state = self._place(anchor)
                    times = times[: anchor_chunk - start_chunk]
                    i = anchor_chunk
                    continue
                fail_streak = 0
                times.append(dt)
                if self.heartbeat is not None:
                    self.heartbeat(i, dt)
                i += 1
                at_cadence = (i - start_chunk) % self.checkpoint_every == 0
                if at_cadence or i == self.n_chunks:
                    if self.manager is not None:
                        self._save(state, i, prior_times + times)
                        checkpoints += 1
                    if self._needs_anchor:
                        anchor = self._snapshot(state)
                        anchor_chunk = i
        except BaseException as e:  # noqa: BLE001 — black-box dump, re-raised
            self._dump_on_failure(e, chunk=i)
            raise
        finally:
            self._close_watchdog()
        self._record("run-complete", chunks_done=self.n_chunks)
        return RunReport(state, True, times, provenance(self.n_chunks))

    def _dump_on_failure(self, exc: BaseException, chunk: int) -> None:
        """Any failure that escapes the retry loop dumps the
        flight-recorder ring atomically beside the checkpoints (and
        under $WITT_OBS_DIR if set) before the exception propagates."""
        if self.recorder is None:
            return
        from ..obs.recorder import failure_dump_paths

        kind = classify(exc)
        self._record(
            "failure", chunk=chunk, error_kind=kind,
            error=type(exc).__name__, message=str(exc)[:500],
            typed=isinstance(exc, DurableRunError),
        )
        ckpt_dir = self.manager.directory if self.manager is not None else None
        for path in failure_dump_paths(ckpt_dir):
            try:
                self.recorder.dump(path)
            except OSError:
                pass  # forensics must never mask the real failure

    # -- convenience ----------------------------------------------------

    @classmethod
    def from_network(
        cls,
        net: Any,
        state: Any,
        *,
        total_ms: int,
        chunk_ms: int,
        batched: bool = True,
        stop_when_done: bool = False,
        donate: bool = False,
        run_key: Optional[str] = None,
        **kw,
    ) -> "Supervisor":
        """A supervisor whose chunk_fn is an eager chunk_ms slice of
        net.run_ms_batched (or net.run_ms).

        `donate` is accepted for the JAX package's signature and has no
        effect: the port runs eagerly and has no buffers to donate.  For
        degradation pass `cpu_chunk_fn` (e.g. a slice of the same
        network built with device="cpu") with
        `degrade=DegradePolicy(cpu_fallback=True)`.

        stop_when_done: the early exit changes which ticks execute per
        chunk boundary, so bit-identity of a chunked vs straight run is
        only promised for the default stop_when_done=False."""
        del donate
        if total_ms % chunk_ms != 0:
            raise ValueError(
                f"total_ms={total_ms} must be a multiple of chunk_ms={chunk_ms}"
            )
        n_chunks = total_ms // chunk_ms
        runner = net.run_ms_batched if batched else net.run_ms

        def chunk_fn(s):
            return runner(s, chunk_ms, stop_when_done)

        if run_key is None:
            run_key = stable_run_key(net, state, n_chunks, chunk_ms)
        return cls(
            chunk_fn,
            state,
            n_chunks=n_chunks,
            chunk_ms=chunk_ms,
            run_key=run_key,
            **kw,
        )
