"""Declarative SLOs evaluated as multi-window burn rates, in-process.

An SLOSpec names a metric in a TimeSeriesStore, how to reduce it over
a window (quantile / rate / mean / last), and the objective it must
meet.  The SLOEngine evaluates every spec over TWO windows — the fast
window (default 5 min) and the slow window (default 1 h), the Google
SRE multi-window pattern — and computes a *burn rate* per window:

    direction "le"  (latency, error rate):  burn = measured / objective
    direction "ge"  (throughput floors):    burn = objective / measured

burn >= 1.0 means the objective is being violated at that window's
timescale.  Both windows over threshold -> **page** (it is bad AND
still happening); only the slow window over -> **warn** (a past burst
still inside the 1-h memory); fast-only never fires on its own (a
blip that the slow window hasn't confirmed is noise).  A spec whose
metric has no samples in the slow window reports ``no_data`` and never
fires — the sims/s floor SLO stays silent in a serve fleet that never
feeds a sims/s series.

Firing is edge-triggered: an alert is emitted once per
inactive->active transition (typed ``slo-alert`` flight-recorder event
+ ``witt_obs_alerts_total{slo,severity}`` tick), then latched until
the engine observes it clear, which emits ``slo-resolved``.  The alert
event carries the trace ids of the newest contributing sample, so a
quarantine alert names the poison job's run.

Zero objectives are the degenerate-but-useful case: "error rate <= 0"
fires on ANY error in the window (burn is reported as BURN_CAP).

``REGISTERED_SLOS`` is the catalog: every alert-capable call site
(SLOSpec construction, ``fire_violation``) must name an entry here, so a
dashboard keyed on slo names can never silently miss an alert source.

Ported from the JAX package's obs/slo.py.  One design difference:
``default_serve_specs`` reads no file.  The JAX package arms its sims/s
floor from ``BENCH_FLOOR.json``, a CPU figure of that package, not a
figure of the card; the port arms the floor only when the caller passes
``floor=``, so ``default_serve_specs()`` equals the JAX package's
``default_serve_specs(floor=0)``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

from .timeseries import TimeSeriesStore

# Burn rates are capped here for JSON-safety (a zero objective makes
# the true burn infinite).
BURN_CAP = 1e9

FAST_WINDOW_S = 300.0  # 5 min: "is it still happening?"
SLOW_WINDOW_S = 3600.0  # 1 h:   "is it significant?"

#: The registered SLO catalog — the only names an alert may carry.
#: Window-evaluated serve/campaign SLOs first, then the runtime
#: invariants the sentinel (obs/monitor.py) fires directly.
REGISTERED_SLOS = (
    "queue-wait-p95",
    "ttfr-p95",
    "sims-per-sec-floor",
    "error-kind-rate",
    "lane-restart-rate",
    "store-invariant",
    "capacity-dropped",
    "hwm-headroom",
    "attribution-reconcile",
)


@dataclass(frozen=True)
class SLOSpec:
    """One declarative objective over one metric series."""

    name: str  # must be in REGISTERED_SLOS
    metric: str  # series name in the TimeSeriesStore
    objective: float  # the threshold
    #: how to reduce the window's samples to one measured value
    reduce: str = "quantile"  # quantile | rate | mean | last
    q: float = 0.95  # for reduce="quantile"
    #: "le": measured must stay <= objective; "ge": >= objective
    direction: str = "le"
    fast_window_s: float = FAST_WINDOW_S
    slow_window_s: float = SLOW_WINDOW_S
    #: burn >= this fires (1.0 = objective exactly met is the edge)
    burn_threshold: float = 1.0
    description: str = ""

    def __post_init__(self):
        if self.name not in REGISTERED_SLOS:
            raise ValueError(
                f"SLO {self.name!r} is not in REGISTERED_SLOS — register "
                "it in obs/slo.py first"
            )
        if self.reduce not in ("quantile", "rate", "mean", "last"):
            raise ValueError(f"unknown reduce {self.reduce!r}")
        if self.direction not in ("le", "ge"):
            raise ValueError(f"unknown direction {self.direction!r}")
        if self.fast_window_s <= 0 or self.slow_window_s < self.fast_window_s:
            raise ValueError(
                "need 0 < fast_window_s <= slow_window_s, got "
                f"{self.fast_window_s}/{self.slow_window_s}"
            )


def _burn(measured: Optional[float], objective: float,
          direction: str) -> Optional[float]:
    """Burn rate (>= 1.0 means violating), capped for JSON-safety."""
    if measured is None:
        return None
    if direction == "le":
        if objective <= 0:
            return BURN_CAP if measured > 0 else 0.0
        return min(BURN_CAP, measured / objective)
    # "ge": a floor — burning when measured falls below it
    if measured <= 0:
        return BURN_CAP if objective > 0 else 0.0
    return min(BURN_CAP, objective / measured)


class SLOEngine:
    """Evaluate specs against a TimeSeriesStore; latch + count alerts.

    Thread-safe: evaluate() may be called from lane workers, the HTTP
    handler, and tests concurrently.  Cheap enough to run on every
    error observation (a handful of window scans over bounded rings).
    """

    def __init__(self, store: TimeSeriesStore,
                 specs: Optional[List[SLOSpec]] = None,
                 recorder=None, clock=None):
        self.store = store
        self.specs = list(specs or [])
        self.recorder = recorder
        self._clock = clock or store._clock
        self._lock = threading.Lock()
        self._active: Dict[str, dict] = {}  # slo name -> firing alert
        self._alerts_total: Dict[tuple, int] = {}  # (slo, severity) -> n
        self._last_eval: List[dict] = []

    # -- evaluation ----------------------------------------------------

    def _measure(self, spec: SLOSpec, window_s: float,
                 now: float) -> Optional[float]:
        if spec.reduce == "quantile":
            vals = self.store.values(spec.metric, window_s, now)
            if not vals:
                return None
            return self.store.quantile(spec.metric, spec.q, window_s, now)
        if spec.reduce == "rate":
            if self.store.count(spec.metric, window_s, now) == 0 and \
                    self.store.last(spec.metric) is None:
                return None
            return self.store.rate(spec.metric, window_s, now)
        if spec.reduce == "mean":
            return self.store.mean(spec.metric, window_s, now)
        return self.store.last(spec.metric)  # "last"

    def evaluate(self, now: Optional[float] = None) -> List[dict]:
        """Evaluate every spec; emit edge-triggered alerts; return the
        per-spec status rows (/w/slo's payload)."""
        t = self._clock() if now is None else now
        rows = []
        fired, resolved = [], []
        with self._lock:
            for spec in self.specs:
                fast = self._measure(spec, spec.fast_window_s, t)
                slow = self._measure(spec, spec.slow_window_s, t)
                burn_fast = _burn(fast, spec.objective, spec.direction)
                burn_slow = _burn(slow, spec.objective, spec.direction)
                if burn_slow is None:
                    state, severity = "no_data", None
                elif burn_slow >= spec.burn_threshold and (
                    burn_fast is not None
                    and burn_fast >= spec.burn_threshold
                ):
                    state, severity = "firing", "page"
                elif burn_slow >= spec.burn_threshold:
                    state, severity = "firing", "warn"
                else:
                    state, severity = "ok", None
                row = {
                    "slo": spec.name,
                    "metric": spec.metric,
                    "objective": spec.objective,
                    "direction": spec.direction,
                    "reduce": spec.reduce,
                    "state": state,
                    "severity": severity,
                    "measured_fast": fast,
                    "measured_slow": slow,
                    "burn_fast": burn_fast,
                    "burn_slow": burn_slow,
                    "fast_window_s": spec.fast_window_s,
                    "slow_window_s": spec.slow_window_s,
                }
                rows.append(row)
                was = self._active.get(spec.name)
                if state == "firing":
                    if was is None or was.get("severity") != severity:
                        ids = self.store.latest_ctx(
                            spec.metric, spec.slow_window_s, t
                        )
                        alert = {**row, "ts": t, "ctx": ids}
                        self._active[spec.name] = alert
                        key = (spec.name, severity)
                        self._alerts_total[key] = (
                            self._alerts_total.get(key, 0) + 1
                        )
                        fired.append(alert)
                elif was is not None and state == "ok":
                    self._active.pop(spec.name, None)
                    resolved.append({**row, "ts": t})
            self._last_eval = rows
        # recorder I/O outside the lock (armed recorders fsync)
        if self.recorder is not None:
            for alert in fired:
                self.recorder.record(
                    "slo-alert",
                    slo=alert["slo"], severity=alert["severity"],
                    metric=alert["metric"], objective=alert["objective"],
                    burn_fast=alert["burn_fast"],
                    burn_slow=alert["burn_slow"],
                    measured=alert["measured_fast"],
                    **(alert.get("ctx") or {}),
                )
            for row in resolved:
                self.recorder.record(
                    "slo-resolved", slo=row["slo"], metric=row["metric"],
                )
        return rows

    # -- direct violations (the invariant sentinel's path) -------------

    def fire_violation(self, slo: str, severity: str = "page",
                       ctx=None, **fields) -> dict:
        """Fire one alert directly, bypassing window evaluation — the
        runtime invariant sentinel's path (an invariant is boolean, not
        a rate).  Still registered, still counted, still typed."""
        if slo not in REGISTERED_SLOS:
            raise ValueError(
                f"SLO {slo!r} is not in REGISTERED_SLOS"
            )
        alert = {
            "slo": slo, "severity": severity, "state": "firing",
            "ts": self._clock(), **fields,
        }
        with self._lock:
            key = (slo, severity)
            self._alerts_total[key] = self._alerts_total.get(key, 0) + 1
            self._active[slo] = alert
        if self.recorder is not None:
            ids = ctx.ids() if hasattr(ctx, "ids") else (ctx or {})
            self.recorder.record(
                "invariant-violation", slo=slo, severity=severity,
                **ids, **fields,
            )
        return alert

    # -- exposition ----------------------------------------------------

    def alert_counts(self) -> dict:
        """{"total": n, "by_slo": {name: n}, "by_severity": {sev: n}}."""
        with self._lock:
            items = list(self._alerts_total.items())
        by_slo: Dict[str, int] = {}
        by_sev: Dict[str, int] = {}
        for (slo, sev), n in items:
            by_slo[slo] = by_slo.get(slo, 0) + n
            by_sev[sev] = by_sev.get(sev, 0) + n
        return {
            "total": sum(n for _, n in items),
            "by_slo": dict(sorted(by_slo.items())),
            "by_severity": dict(sorted(by_sev.items())),
        }

    def status(self, evaluate: bool = True) -> dict:
        """The /w/slo payload: spec rows, active alerts, counters."""
        rows = self.evaluate() if evaluate else list(self._last_eval)
        with self._lock:
            active = [dict(a) for a in self._active.values()]
        return {
            "slos": rows,
            "activeAlerts": active,
            "alerts": self.alert_counts(),
            "series": self.store.summary(),
        }

    def add_prometheus(self, p) -> None:
        """witt_obs_alerts_total{slo,severity} + firing gauge."""
        with self._lock:
            totals = dict(self._alerts_total)
            active = {a["slo"]: a for a in self._active.values()}
        for (slo, sev), n in sorted(totals.items()):
            p.add("obs_alerts_total", n,
                  "SLO burn-rate + invariant alerts fired (edge-"
                  "triggered transitions)", "counter",
                  {"slo": slo, "severity": sev})
        for spec in self.specs:
            p.add("obs_slo_firing",
                  1 if spec.name in active else 0,
                  "1 while the named SLO is latched firing", "gauge",
                  {"slo": spec.name})


# -- the default serve-fleet spec set ---------------------------------------


def default_serve_specs(
    floor: Optional[float] = None,
    fast_window_s: float = FAST_WINDOW_S,
    slow_window_s: float = SLOW_WINDOW_S,
) -> List[SLOSpec]:
    """The serve fleet's standing objectives.  Queue-wait and TTFR
    bounds are deliberately generous (CI hosts are slow and shared);
    the zero-objective error/restart SLOs are the sharp ones — any
    error kind or lane restart inside the window fires.  The sims/s
    floor arms only when ``floor`` is given (a floor measured on the
    card; the serve path never feeds the series)."""
    specs = [
        SLOSpec(
            name="queue-wait-p95", metric="serve.queue_wait_s",
            objective=30.0, reduce="quantile", q=0.95,
            fast_window_s=fast_window_s, slow_window_s=slow_window_s,
            description="p95 admission->dispatch wait stays under 30 s",
        ),
        SLOSpec(
            name="ttfr-p95", metric="serve.ttfr_s",
            objective=60.0, reduce="quantile", q=0.95,
            fast_window_s=fast_window_s, slow_window_s=slow_window_s,
            description="p95 submit->first-result stays under 60 s",
        ),
        SLOSpec(
            name="error-kind-rate", metric="serve.errors_total",
            objective=0.0, reduce="rate",
            fast_window_s=fast_window_s, slow_window_s=slow_window_s,
            description="zero failed/quarantined jobs (any error fires)",
        ),
        SLOSpec(
            name="lane-restart-rate", metric="serve.lane_restarts_total",
            objective=0.0, reduce="rate",
            fast_window_s=fast_window_s, slow_window_s=slow_window_s,
            description="zero lane deaths (any supervised restart fires)",
        ),
    ]
    if floor:
        specs.append(
            SLOSpec(
                name="sims-per-sec-floor", metric="campaign.sims_per_sec",
                objective=float(floor), reduce="mean", direction="ge",
                fast_window_s=fast_window_s, slow_window_s=slow_window_s,
                description="measured sims/s stays above the given floor",
            )
        )
    return specs
