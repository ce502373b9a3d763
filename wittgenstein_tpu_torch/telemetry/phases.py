"""Per-phase tick timing: one loop shared by every caller, its passes
recorded as spans on the telemetry tracer.

Port of the JAX package's telemetry/phases.py.  Each named phase
function (state -> state) is applied `scans` times in a row to the
batched states, and the passes are timed on the host clock, with
`torch.cuda.synchronize` around each timed pass on CUDA.  Phases overlap
by construction (delivery is part of the full step), so the numbers rank
op costs; they do not partition a tick.

Warm-up discipline: the first pass pays the one-time costs (kernel
builds, allocator growth), the second residual dispatch, so one build
pass and one discarded warm-up pass run before the `repeats` timed
passes, and each phase reports a mean and a standard deviation; a delta
is only trustworthy where it exceeds the measured spread.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, Optional

import torch

from .trace import SpanTracer, maybe_span


def _sync(states) -> None:
    if states.time.is_cuda:
        torch.cuda.synchronize(states.time.device)


def scan_phase_seconds(
    states,
    phases: Dict[str, Callable],
    scans: int = 25,
    tracer: Optional[SpanTracer] = None,
    repeats: int = 3,
) -> Dict[str, dict]:
    """Per-iteration timing for each named phase fn over the batched
    `states`, applied `scans` times per pass.

    Per phase: one untimed build pass, one discarded warm-up pass, then
    `repeats` timed passes.  Returns
    {name: {mean_s, std_s, min_s, samples_s, scans, repeats}} where the
    *_s values are seconds per iteration.  Every pass is recorded as a
    span when a tracer is given."""

    def one_pass(fn):
        s = states
        for _ in range(scans):
            s = fn(s)
        _sync(s)

    out: Dict[str, dict] = {}
    repeats = max(1, int(repeats))
    for name, fn in phases.items():
        _sync(states)
        with maybe_span(tracer, "compile", phase=name, scans=scans):
            one_pass(fn)
        with maybe_span(tracer, "warmup-discarded", phase=name, scans=scans):
            one_pass(fn)
        samples = []
        for r in range(repeats):
            with maybe_span(tracer, "measure", phase=name, scans=scans, repeat=r):
                t0 = time.perf_counter()
                one_pass(fn)
                samples.append((time.perf_counter() - t0) / scans)
        mean = sum(samples) / len(samples)
        var = sum((x - mean) ** 2 for x in samples) / len(samples)
        out[name] = {
            "mean_s": mean,
            "std_s": math.sqrt(var),
            "min_s": min(samples),
            "samples_s": samples,
            "scans": scans,
            "repeats": repeats,
        }
    return out


def phase_means(stats: Dict[str, dict]) -> Dict[str, float]:
    """Collapse a scan_phase_seconds() result to {name: mean seconds},
    for callers that only rank phases."""
    return {k: v["mean_s"] for k, v in stats.items()}


def engine_phase_fns(net) -> Dict[str, Callable]:
    """The engine-generic phase set: full step, delivery + clear,
    delivery + emission apply, protocol tick, beat.  Each phase but the
    full step runs at the batch's shared clock (one device read a call)
    and leaves the clock where it was, as in the JAX package."""
    proto = net.protocol
    clock = net.lockstep_time
    return {
        "full_step": net.step,
        "delivery": lambda s: net._phase_deliver(s, clock(s)),
        "deliver_apply": lambda s: net._phase_deliver_apply(s, clock(s)),
        "protocol_tick": lambda s: proto.tick(net, s, clock(s)),
        "beat": lambda s: proto.tick_beat(net, s, clock(s)),
    }
