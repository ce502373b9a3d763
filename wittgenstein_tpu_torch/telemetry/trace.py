"""Host-side span tracer -> Chrome trace-event JSON.

Port of the JAX package's telemetry/trace.py (pure Python, copied so the
port imports nothing of that package).  Explicit, dependency-free spans
for the phases the host controls (build, warm-up, chunks), written in
the Chrome trace-event format (the `{"traceEvents": [...]}` JSON object
form), which chrome://tracing, Perfetto and speedscope open directly; the
device side is torch.profiler's.

    tracer = SpanTracer()
    with tracer.span("build", nodes=4096):
        net, state = make_handel(params)
    for i in range(n_chunks):
        with tracer.span("chunk", index=i):
            states = net.run_ms_batched(states, 20)
    tracer.write("trace.json")

Spans nest (same tid, enclosing durations) and are threadsafe: each
thread gets its own tid lane.

Correlation: construct with ``ctx=`` (any object with ``.ids() ->
dict``, or a plain dict) and every span and instant carries the run's
correlation ids (run_id / job_id / tenant_id) in its args, and the ids
are emitted once as a metadata event, so a trace joins a run's other
records on run_id.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Iterator, Optional


class SpanTracer:
    """Collects complete ("ph": "X") trace events with microsecond
    timestamps relative to tracer construction."""

    def __init__(self, process_name: str = "wittgenstein-tpu", ctx=None):
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._tids = {}  # thread ident -> small stable tid
        self._ctx_ids: dict = {}
        self.events = [
            {
                "ph": "M",
                "name": "process_name",
                "pid": os.getpid(),
                "tid": 0,
                "args": {"name": process_name},
            }
        ]
        if ctx is not None:
            self.set_context(ctx)

    def set_context(self, ctx) -> None:
        """Attach correlation ids (any ``.ids()``
        carrier, or a plain dict): merged into the args of every
        subsequent span/instant, and emitted once as a metadata event
        so the ids survive even in a span-free trace."""
        ids = dict(ctx.ids()) if hasattr(ctx, "ids") else dict(ctx)
        with self._lock:
            self._ctx_ids = ids
            self.events.append(
                {
                    "ph": "M",
                    "name": "trace_context",
                    "pid": os.getpid(),
                    "tid": 0,
                    "args": ids,
                }
            )

    def _with_ctx(self, args: dict) -> dict:
        if not self._ctx_ids:
            return args
        merged = dict(self._ctx_ids)
        merged.update(args)
        return merged

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def now_us(self) -> float:
        """The tracer's clock (µs since construction) — for callers that
        time work themselves and report via add_span."""
        return self._now_us()

    def _tid(self) -> int:
        ident = threading.get_ident()
        with self._lock:
            return self._tids.setdefault(ident, len(self._tids))

    def add_span(self, name: str, start_us: float, dur_us: float, **args):
        """Record a completed span directly (for spans timed elsewhere)."""
        ev = {
            "ph": "X",
            "name": name,
            "pid": os.getpid(),
            "tid": self._tid(),
            "ts": round(start_us, 1),
            "dur": round(dur_us, 1),
        }
        args = self._with_ctx(args)
        if args:
            ev["args"] = args
        with self._lock:
            self.events.append(ev)
        return ev

    @contextlib.contextmanager
    def span(self, name: str, **args) -> Iterator[None]:
        t0 = self._now_us()
        try:
            yield
        finally:
            self.add_span(name, t0, self._now_us() - t0, **args)

    def instant(self, name: str, **args):
        ev = {
            "ph": "i",
            "name": name,
            "pid": os.getpid(),
            "tid": self._tid(),
            "ts": round(self._now_us(), 1),
            "s": "t",
        }
        args = self._with_ctx(args)
        if args:
            ev["args"] = args
        with self._lock:
            self.events.append(ev)
        return ev

    def to_json(self) -> dict:
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms"}

    def write(self, path: str) -> str:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_json(), f)
        return path


def validate_chrome_trace(doc: dict) -> None:
    """Raise ValueError unless `doc` is a well-formed trace-event JSON
    object (the export-format contract the tests pin)."""
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("not a trace-event JSON object form")
    for ev in doc["traceEvents"]:
        if "ph" not in ev or "name" not in ev:
            raise ValueError(f"event missing ph/name: {ev!r}")
        if ev["ph"] == "X" and ("ts" not in ev or "dur" not in ev):
            raise ValueError(f"complete event missing ts/dur: {ev!r}")


@contextlib.contextmanager
def maybe_span(tracer: Optional[SpanTracer], name: str, **args):
    """Span when a tracer is present, no-op otherwise (lets call sites
    stay unconditional)."""
    if tracer is None:
        yield
    else:
        with tracer.span(name, **args):
            yield
