"""Telemetry: device-side counters, the progress snapshot ring, host
exports.

Port of the JAX package's telemetry/:

  state.py   TelemetryConfig + TelemetryState, the counter side-car the
             engine updates at its send, insert, delivery and jump sites,
             and the on-device snapshot ring.  The switch is static: an
             engine without a config runs no telemetry op.
  export.py  the host layer: counter summaries, Prometheus text, JSONL
             run records, snapshot-ring decoding (progress curves and
             done-at CDFs in one read).
  trace.py   SpanTracer: Chrome trace-event JSON for host phases.
  phases.py  the shared per-phase tick-cost loop.

Turn it on at construction or on a built simulation:

    from wittgenstein_tpu_torch.telemetry import TelemetryConfig, counters
    net, state = make_handel(params, telemetry=TelemetryConfig(
        snapshots=128, snapshot_every_ms=10))
    # or: net, states = net.with_telemetry(states, TelemetryConfig())
    out = net.run_ms_batched(replicate_state(state, 16), 1000)
    summary = counters(net, out)               # dict for run records
    text = prometheus_from_counters(summary)   # /metrics payload
    series = progress_series(out)              # time/done/pending curves
"""

from .export import (
    PromText,
    RunRecordWriter,
    counters,
    done_counts_at,
    pending_count,
    progress_series,
    prometheus_from_counters,
    read_run_records,
)
from .phases import engine_phase_fns, phase_means, scan_phase_seconds
from .state import TelemetryConfig, TelemetryState, init_telemetry
from .trace import SpanTracer, maybe_span, validate_chrome_trace

__all__ = [
    "PromText",
    "RunRecordWriter",
    "SpanTracer",
    "TelemetryConfig",
    "TelemetryState",
    "counters",
    "done_counts_at",
    "engine_phase_fns",
    "init_telemetry",
    "maybe_span",
    "pending_count",
    "phase_means",
    "progress_series",
    "prometheus_from_counters",
    "read_run_records",
    "scan_phase_seconds",
    "validate_chrome_trace",
]
