"""SLO observability for the serving layer.

One ServeMetrics instance per scheduler aggregates the host-side
signals the batching design is judged by:

  * queue depth and admission rejections (backpressure pressure);
  * batch occupancy — packed replicas / capacity — the continuous-
    batching headline (an occupancy of 0 means batching is silently
    disabled);
  * run-cache effectiveness, re-exported from the run cache's
    monotonic counters as a hit ratio (the "fixed number of programs"
    claim, measurable);
  * per-job latency and time-to-first-result quantiles (p50/p99 over a
    bounded reservoir of completed jobs);
  * preemption/resume counts for the priority-interleaving path;
  * per-tenant attribution (ticks, device-time share, dropped/fault
    counters — fed by the scheduler's obs.batch_attribution slices)
    and per-run latency samples labelled {run_id, tenant} over a small
    bounded window, so an external scraper can join /metrics to the
    flight-recorder / run-record ledger on run_id without us exporting
    an unbounded label cardinality.

Rendering goes through the port's telemetry.export.PromText — one text
format, one scrape.  Ported from the JAX package's serve/metrics.py.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import List, Optional

from ..obs.timeseries import TimeSeriesStore


def quantile(values: List[float], q: float) -> float:
    """Nearest-rank quantile of a non-empty list (0 for empty)."""
    if not values:
        return 0.0
    xs = sorted(values)
    idx = min(len(xs) - 1, max(0, int(round(q * (len(xs) - 1)))))
    return xs[idx]


class ServeMetrics:
    """Thread-safe aggregation; every mutation takes the lock, render()
    reads a consistent snapshot."""

    #: completed-job reservoir bound for the latency quantiles
    WINDOW = 1024
    #: bounded window of per-run labelled latency samples (cardinality
    #: guard: /metrics carries the last RUN_WINDOW runs, the full
    #: ledger lives in the flight recorder / run records)
    RUN_WINDOW = 32

    def __init__(self):
        self._lock = threading.Lock()
        # the in-process metric history the SLO burn-rate engine reads:
        # every observation below also lands here as a windowed sample
        # (series named serve.*, see obs/timeseries.py)
        self.timeseries = TimeSeriesStore()
        self.jobs_submitted = 0
        self.jobs_completed = 0
        self.jobs_failed = 0
        self.jobs_cancelled = 0
        self.jobs_quarantined = 0
        self.batches_total = 0
        self.replicas_packed_total = 0
        self.replicas_capacity_total = 0
        self.last_occupancy = 0.0
        self.preemptions_total = 0
        self.resumes_total = 0
        self.batch_seconds_total = 0.0
        # wave packing: width = lanes busy when a dispatch starts
        self.wave_width_last = 0
        self.wave_width_max = 0
        # lane index -> dispatch count (busy seconds live on the lanes)
        self._lane_dispatches: dict = {}
        # fleet resilience: lane supervision + batch salvage + drain
        self.lane_failures_total = 0
        self.lane_restarts_total = 0
        self.lane_rebinds_total = 0
        self.bindings_expired_total = 0
        self.salvage_batches_total = 0
        self.salvage_runs_total = 0
        self.salvage_seconds_total = 0.0
        self.drains_total = 0
        # done-row harvesting: parked batches compacted to a smaller
        # capacity bucket mid-run, and the padding rows freed by it
        self.harvests_total = 0
        self.harvest_rows_freed_total = 0
        self.rows_done_last = 0
        self._latency_s = deque(maxlen=self.WINDOW)
        self._ttfr_s = deque(maxlen=self.WINDOW)
        # (run_id, tenant, latency_s) of recently completed jobs
        self._recent_runs = deque(maxlen=self.RUN_WINDOW)
        # tenant -> accumulated attribution counters
        self._tenants: dict = {}

    # -- observations --------------------------------------------------

    def observe_submit(self) -> None:
        with self._lock:
            self.jobs_submitted += 1

    def observe_job(self, job) -> None:
        from .jobs import JobState

        with self._lock:
            if job.state is JobState.DONE:
                self.jobs_completed += 1
            elif job.state is JobState.FAILED:
                self.jobs_failed += 1
            elif job.state is JobState.CANCELLED:
                self.jobs_cancelled += 1
            elif job.state is JobState.QUARANTINED:
                self.jobs_quarantined += 1
            if job.finished_at and job.submitted_at:
                lat = job.finished_at - job.submitted_at
                self._latency_s.append(lat)
                run_id = getattr(job, "run_id", None)
                if run_id:
                    tenant = (
                        job.spec.tenant if job.spec is not None else "default"
                    )
                    self._recent_runs.append((run_id, tenant, lat))
            if job.first_result_at and job.submitted_at:
                self._ttfr_s.append(job.first_result_at - job.submitted_at)
        ids = self._job_ids(job)
        if job.started_at and job.submitted_at:
            self.timeseries.observe(
                "serve.queue_wait_s", job.started_at - job.submitted_at,
                ctx=ids,
            )
        if job.state in (JobState.FAILED, JobState.QUARANTINED):
            # the victim's ids ride the sample, so a burn-rate alert off
            # this series names the run that tripped it
            self.timeseries.inc("serve.errors_total", ctx=ids)

    @staticmethod
    def _job_ids(job) -> Optional[dict]:
        run_id = getattr(job, "run_id", None)
        if not run_id:
            return None
        return {
            "run_id": run_id,
            "job_id": getattr(job, "id", None),
            "tenant_id": (
                job.spec.tenant if getattr(job, "spec", None) else None
            ),
        }

    def observe_tenant(self, tenant: str, job_attrib: Optional[dict]) -> None:
        """Fold one completed job's attribution slice into its tenant's
        running totals (scheduler calls this at batch finalize)."""
        if not job_attrib:
            return
        with self._lock:
            t = self._tenants.setdefault(
                tenant,
                {
                    "jobs": 0,
                    "ticks": 0,
                    "dropped": 0,
                    "fault_dropped": 0,
                    "device_time_share_last": 0.0,
                },
            )
            t["jobs"] += 1
            for src, dst in (
                ("ticks", "ticks"),
                ("dropped", "dropped"),
                ("fault_dropped", "fault_dropped"),
            ):
                if job_attrib.get(src) is not None:
                    t[dst] += job_attrib[src]
            if job_attrib.get("device_time_share") is not None:
                t["device_time_share_last"] = job_attrib["device_time_share"]

    def observe_batch(
        self, packed: int, capacity: int, seconds: float
    ) -> None:
        with self._lock:
            self.batches_total += 1
            self.replicas_packed_total += packed
            self.replicas_capacity_total += capacity
            self.last_occupancy = packed / capacity if capacity else 0.0
            self.batch_seconds_total += seconds

    def observe_ttfr(self, job) -> None:
        """First progress visible for a still-running job (chunked path
        slices report between device calls)."""
        import time

        with self._lock:
            if job.first_result_at is None:
                job.first_result_at = time.monotonic()
                ttfr = job.first_result_at - job.submitted_at
                self._ttfr_s.append(ttfr)
            else:
                ttfr = None
        if ttfr is not None:
            self.timeseries.observe(
                "serve.ttfr_s", ttfr, ctx=self._job_ids(job)
            )

    def observe_wave(self, lane: int, width: int) -> None:
        """One dispatch started on ``lane`` while ``width`` lanes were
        busy (this one included) — the wave-packing headline: a steady
        width of G means G families genuinely execute concurrently."""
        with self._lock:
            self.wave_width_last = width
            self.wave_width_max = max(self.wave_width_max, width)
            self._lane_dispatches[lane] = (
                self._lane_dispatches.get(lane, 0) + 1
            )

    def observe_preemption(self) -> None:
        with self._lock:
            self.preemptions_total += 1

    def observe_resume(self) -> None:
        with self._lock:
            self.resumes_total += 1

    # -- fleet resilience ----------------------------------------------

    def observe_lane_failure(self, ctx=None) -> None:
        with self._lock:
            self.lane_failures_total += 1
        self.timeseries.inc("serve.lane_failures_total", ctx=ctx)

    def observe_lane_restart(self, ctx=None) -> None:
        with self._lock:
            self.lane_restarts_total += 1
        self.timeseries.inc("serve.lane_restarts_total", ctx=ctx)

    def observe_rebind(self, n: int = 1) -> None:
        """``n`` sticky family bindings moved off a failed lane."""
        with self._lock:
            self.lane_rebinds_total += n

    def observe_binding_expired(self, n: int = 1) -> None:
        with self._lock:
            self.bindings_expired_total += n

    def observe_salvage(self, runs: int, seconds: float) -> None:
        """One batch salvage completed: ``runs`` probe/re-run dispatches
        costing ``seconds`` of wall time (the salvage overhead
        the serving report tracks)."""
        with self._lock:
            self.salvage_batches_total += 1
            self.salvage_runs_total += runs
            self.salvage_seconds_total += seconds

    def observe_drain(self) -> None:
        with self._lock:
            self.drains_total += 1

    def observe_harvest(self, rows_freed: int, ctx=None) -> None:
        """One parked batch compacted into a smaller capacity bucket:
        ``rows_freed`` replica rows stop being re-run each slice."""
        with self._lock:
            self.harvests_total += 1
            self.harvest_rows_freed_total += rows_freed
        self.timeseries.inc("serve.harvests_total", ctx=ctx)

    def observe_rows_done(self, done: int, total: int, ctx=None) -> None:
        """Per-chunk done-row census from the Supervisor's row_watch
        hook (how many member rows have reached their protocol's
        all_done — the signal harvesting efficacy is judged by)."""
        with self._lock:
            self.rows_done_last = done
        self.timeseries.observe("serve.rows_done", float(done), ctx=ctx)
        if total:
            self.timeseries.observe(
                "serve.rows_done_frac", done / total, ctx=ctx
            )

    # -- export --------------------------------------------------------

    def latency_quantiles(self) -> dict:
        with self._lock:
            lat = list(self._latency_s)
            ttfr = list(self._ttfr_s)
        return {
            "latency_p50_s": quantile(lat, 0.50),
            "latency_p99_s": quantile(lat, 0.99),
            "ttfr_p50_s": quantile(ttfr, 0.50),
            "ttfr_p99_s": quantile(ttfr, 0.99),
            "samples": len(lat),
        }

    def summary(self, queue_depth: Optional[int] = None) -> dict:
        """The machine-readable SLO snapshot (report rows)."""
        with self._lock:
            out = {
                "jobs_submitted": self.jobs_submitted,
                "jobs_completed": self.jobs_completed,
                "jobs_failed": self.jobs_failed,
                "jobs_cancelled": self.jobs_cancelled,
                "jobs_quarantined": self.jobs_quarantined,
                "batches_total": self.batches_total,
                "replicas_packed_total": self.replicas_packed_total,
                "replicas_capacity_total": self.replicas_capacity_total,
                "occupancy_avg": (
                    self.replicas_packed_total / self.replicas_capacity_total
                    if self.replicas_capacity_total
                    else 0.0
                ),
                "last_occupancy": self.last_occupancy,
                "preemptions_total": self.preemptions_total,
                "resumes_total": self.resumes_total,
                "batch_seconds_total": round(self.batch_seconds_total, 4),
                "wave_width_last": self.wave_width_last,
                "wave_width_max": self.wave_width_max,
                "lane_dispatches": dict(self._lane_dispatches),
                "lane_failures_total": self.lane_failures_total,
                "lane_restarts_total": self.lane_restarts_total,
                "lane_rebinds_total": self.lane_rebinds_total,
                "bindings_expired_total": self.bindings_expired_total,
                "salvage_batches_total": self.salvage_batches_total,
                "salvage_runs_total": self.salvage_runs_total,
                "salvage_seconds_total": round(
                    self.salvage_seconds_total, 4
                ),
                "drains_total": self.drains_total,
                "harvests_total": self.harvests_total,
                "harvest_rows_freed_total": self.harvest_rows_freed_total,
                "rows_done_last": self.rows_done_last,
            }
        if queue_depth is not None:
            out["queue_depth"] = queue_depth
        out.update(self.latency_quantiles())
        with self._lock:
            out["tenants"] = {k: dict(v) for k, v in self._tenants.items()}
        return out

    def add_prometheus(self, p, queue) -> None:
        """Append the witt_serve_* families to a PromText builder."""
        from ..parallel.replica_shard import run_cache_info

        with self._lock:
            p.add("serve_queue_depth", queue.depth(),
                  "pending jobs awaiting dispatch")
            p.add("serve_queue_capacity", queue.max_depth,
                  "admission-control bound on pending jobs")
            p.add("serve_jobs_rejected_total", queue.rejected_total,
                  "jobs refused by admission control", "counter")
            for state, n in (
                ("submitted", self.jobs_submitted),
                ("completed", self.jobs_completed),
                ("failed", self.jobs_failed),
                ("cancelled", self.jobs_cancelled),
                ("quarantined", self.jobs_quarantined),
            ):
                p.add("serve_jobs_total", n, "job lifecycle counters",
                      "counter", {"state": state})
            p.add("serve_batches_total", self.batches_total,
                  "batched dispatches issued", "counter")
            p.add("serve_batch_replicas_packed_total",
                  self.replicas_packed_total,
                  "live job rows packed onto the replica axis", "counter")
            p.add("serve_batch_replicas_capacity_total",
                  self.replicas_capacity_total,
                  "replica-axis capacity offered by those batches",
                  "counter")
            p.add("serve_batch_occupancy", self.last_occupancy,
                  "packed/capacity of the most recent batch")
            p.add("serve_preemptions_total", self.preemptions_total,
                  "long batches parked for higher-priority work",
                  "counter")
            p.add("serve_resumes_total", self.resumes_total,
                  "parked batches resumed from checkpoint", "counter")
            p.add("serve_batch_seconds_total",
                  round(self.batch_seconds_total, 4),
                  "wall seconds spent in batch dispatches", "counter")
            p.add("serve_wave_width", self.wave_width_last,
                  "busy dispatch lanes when the last batch started")
            p.add("serve_wave_width_max", self.wave_width_max,
                  "peak concurrent dispatch lanes observed")
            p.add("serve_lane_failures_total", self.lane_failures_total,
                  "lane worker threads that died (exception or injected "
                  "kill)", "counter")
            p.add("serve_lane_restarts_total", self.lane_restarts_total,
                  "lane workers restarted by fleet supervision", "counter")
            p.add("serve_lane_rebinds_total", self.lane_rebinds_total,
                  "sticky family bindings moved off a failed lane",
                  "counter")
            p.add("serve_bindings_expired_total",
                  self.bindings_expired_total,
                  "idle sticky family->lane bindings reclaimed", "counter")
            p.add("serve_quarantined_total", self.jobs_quarantined,
                  "jobs quarantined as poison rows by batch salvage",
                  "counter")
            p.add("serve_salvage_batches_total", self.salvage_batches_total,
                  "failed batches put through salvage bisection", "counter")
            p.add("serve_salvage_runs_total", self.salvage_runs_total,
                  "probe/re-run dispatches issued by salvage", "counter")
            p.add("serve_salvage_seconds_total",
                  round(self.salvage_seconds_total, 4),
                  "wall seconds spent salvaging failed batches", "counter")
            p.add("serve_drains_total", self.drains_total,
                  "graceful drains entered via the admin surface",
                  "counter")
            p.add("serve_harvests_total", self.harvests_total,
                  "parked batches compacted to a smaller capacity "
                  "bucket mid-run", "counter")
            p.add("serve_harvest_rows_freed_total",
                  self.harvest_rows_freed_total,
                  "replica rows freed by done-row harvesting", "counter")
            p.add("serve_rows_done", self.rows_done_last,
                  "member rows at all_done in the most recent chunk sync")
            for lane, n in sorted(self._lane_dispatches.items()):
                p.add("serve_lane_dispatches_total", n,
                      "dispatches issued per lane", "counter",
                      {"lane": str(lane)})
            lat = list(self._latency_s)
            ttfr = list(self._ttfr_s)
            recent = list(self._recent_runs)
            tenants = {k: dict(v) for k, v in self._tenants.items()}
        for q in (0.5, 0.99):
            p.add("serve_job_latency_seconds", quantile(lat, q),
                  "submit->finish latency of completed jobs", "gauge",
                  {"quantile": str(q)})
            p.add("serve_time_to_first_result_seconds", quantile(ttfr, q),
                  "submit->first progress/result latency", "gauge",
                  {"quantile": str(q)})
        # per-run samples on the same family: {run_id, tenant} labels
        # join /metrics to the flight recorder / run records; bounded at
        # RUN_WINDOW recent runs so label cardinality cannot grow
        for run_id, tenant, sec in recent:
            p.add("serve_job_latency_seconds", round(sec, 6),
                  "submit->finish latency of completed jobs", "gauge",
                  {"run_id": run_id, "tenant": tenant})
        for tenant, t in sorted(tenants.items()):
            labels = {"tenant": tenant}
            p.add("serve_tenant_jobs_total", t["jobs"],
                  "completed jobs attributed per tenant", "counter", labels)
            p.add("serve_tenant_ticks_total", t["ticks"],
                  "engine loop ticks attributed to the tenant's replica "
                  "rows", "counter", labels)
            p.add("serve_tenant_dropped_total", t["dropped"],
                  "store-overflow drops on the tenant's rows", "counter",
                  labels)
            p.add("serve_tenant_fault_dropped_total", t["fault_dropped"],
                  "fault-lane suppressions on the tenant's rows", "counter",
                  labels)
            p.add("serve_tenant_device_time_share", t["device_time_share_last"],
                  "tenant share of the most recent batch's live row-ticks",
                  "gauge", labels)
        info = run_cache_info()
        lookups = info["hits"] + info["misses"]
        p.add("serve_compile_cache_hit_ratio",
              (info["hits"] / lookups) if lookups else 0.0,
              "run-cache hit ratio (steady workloads approach 1.0)")
