"""Cost and memory accounting of one call of an entry point.

The JAX package summarises a compiled XLA program (`cost_analysis()`,
`memory_analysis()`).  The port runs eagerly and compiles no program, so
the same four names summarise one *call* of an entry instead, recorded
by `record_call`:

  cost    {"wall_seconds", "hand_launches"} always; with a profiler
          window also {"launches", "device_ms"}, every kernel of the call
          read by tools.profiling.window_events;
  memory  {"peak_allocated_bytes", "allocated_bytes", "live_bytes"}, the
          CUDA caching allocator's statistics at the call's end; None on
          the CPU, which has no allocator statistics.

The JAX keys without a counterpart are `flops`, `transcendentals`,
`bytes_accessed` and `optimal_seconds` (XLA's static estimates of the
program: an eager call has no program to estimate) and the
argument/output/temp/code split of `memory_analysis` (the allocator
keeps one pool).  `peak_allocated_bytes` is the allocator's high-water
mark since its last reset, which `record_call` leaves alone: a caller
that wants the call's own peak resets it first
(`torch.cuda.reset_peak_memory_stats`).
"""

from __future__ import annotations

import time
from typing import Any, NamedTuple, Optional

import torch


class CallRecord(NamedTuple):
    """What one call of an entry cost: wall seconds, the hand-written
    kernels' launches, the profiler window (or None), the device, and the
    allocator's peak and allocated bytes at the call's end (None on the
    CPU)."""

    wall_seconds: float
    hand_launches: int
    window: Any
    device: torch.device
    peak_bytes: Optional[int]
    allocated_bytes: Optional[int]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def record_call(fn, *args, device=None, profile: bool = False, **kw):
    """Run `fn(*args, **kw)` once, synchronised, and return (its result,
    a CallRecord).  `device` is where the call runs (default: CUDA; with no
    card, this raises); `profile=True` also reads every kernel of the
    call through a torch.profiler window, at the profiler's cost."""
    from ..engine.core import resolve_device
    from ..ops import kernels
    from ..tools.profiling import window_events

    dev = resolve_device(device)
    before = sum(k.launches for k in kernels.KERNELS)
    _sync(dev)
    window = None
    if profile:
        from torch.profiler import ProfilerActivity, profile as _profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        prof = _profile(activities=acts)
        t0 = time.perf_counter()
        with prof:
            out = fn(*args, **kw)
            _sync(dev)
        wall = time.perf_counter() - t0
        window = window_events(prof)
    else:
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        _sync(dev)
        wall = time.perf_counter() - t0
    hand = sum(k.launches for k in kernels.KERNELS) - before
    peak = allocated = None
    if dev.type == "cuda":
        peak = int(torch.cuda.max_memory_allocated(dev))
        allocated = int(torch.cuda.memory_allocated(dev))
    return out, CallRecord(wall, hand, window, dev, peak, allocated)


def cost_analysis_dict(record: CallRecord) -> Optional[dict]:
    """The call's cost: wall seconds and hand-written launches, and with a
    profiler window every kernel's launches and device ms."""
    if record is None:
        return None
    out = {"wall_seconds": record.wall_seconds, "hand_launches": record.hand_launches}
    if record.window is not None:
        out["launches"] = record.window.launches
        out["device_ms"] = record.window.device_ms
    return out


def memory_analysis_dict(record: CallRecord) -> Optional[dict]:
    """The allocator's statistics at the call's end on a card, with
    "live_bytes" = the peak (the footprint that had to fit); None on the
    CPU."""
    if record is None or record.peak_bytes is None:
        return None
    return {
        "peak_allocated_bytes": record.peak_bytes,
        "allocated_bytes": record.allocated_bytes,
        "live_bytes": record.peak_bytes,
    }


def compiled_cost_summary(record: CallRecord, compile_seconds: Optional[float] = None) -> dict:
    """The record the run cache keeps for a program: the cost and memory
    of its first call, and compile seconds where the caller timed any
    (an eager port has none to time)."""
    out: dict = {
        "cost": cost_analysis_dict(record),
        "memory": memory_analysis_dict(record),
    }
    if compile_seconds is not None:
        out["compile_seconds"] = round(float(compile_seconds), 3)
    return out


def format_bytes(n: Any) -> str:
    """Human side-channel for reports: 111_149_056 -> '106.0 MiB'."""
    try:
        n = float(n)
    except (TypeError, ValueError):
        return str(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0 or unit == "TiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0
    return f"{n:.1f} TiB"
