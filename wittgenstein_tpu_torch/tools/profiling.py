"""Profiling helpers on torch.profiler: a trace over a block, named regions
inside it, a host wall clock, and the reader that turns a profiler window
into its kernels, aten ops, launches and device milliseconds.

Usage:

    from wittgenstein_tpu_torch.tools.profiling import trace, window_events
    with trace("trace-dir") as prof:
        out = net.run_ms_batched(states, 10)
        torch.cuda.synchronize()
    w = window_events(prof)
    w.launches, w.device_ms, w.ops["aten::gather"]

`trace` writes `trace.json` (Chrome trace format, for Perfetto) into
`log_dir` when the block ends.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import os
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator["torch.profiler.profile"]:
    """torch.profiler over the with-block (CPU, and CUDA where a card is
    present), stopped even on failure; yields the profiler and writes its
    Chrome trace to `log_dir/trace.json`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    with prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region inside a trace (a user annotation on the CPU track)."""
    with torch.profiler.record_function(name):
        yield


class WallClock:
    """A host-side timer: `with WallClock() as w: ...; w.seconds`."""

    def __enter__(self) -> "WallClock":
        self._t0 = time.perf_counter()
        self.seconds: Optional[float] = None
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = time.perf_counter() - self._t0


class Kernel(NamedTuple):
    """A device event of a profile window: its name and device us."""

    name: str
    device_time: float


class Window(NamedTuple):
    """A profile window's reading: its device events in torch's event
    order, and each aten op's [calls, self device us] by name, in
    first-seen order."""

    kernels: List[Kernel]
    ops: Dict[str, list]

    @property
    def launches(self) -> int:
        return len(self.kernels)

    @property
    def device_ms(self) -> float:
        return sum(k.device_time for k in self.kernels) / 1e3


class _CpuEv:
    """A CPU event of a profile window, as torch's processing nests it."""

    __slots__ = ("name", "start", "end", "thread", "async_", "kernels", "children", "parent",
                 "total")

    def __init__(self, name, start, end, thread, async_):
        self.name, self.start, self.end, self.thread = name, start, end, thread
        self.async_, self.kernels, self.children, self.parent = async_, [], [], None
        self.total = None

    def device_total(self) -> float:
        """device_time_total: own kernels, then the children's, summed as
        torch sums them."""
        if self.total is None:
            self.total = (0 if self.async_ else sum(self.kernels)
                          + sum(ch.device_total() for ch in self.children))
        return self.total


def _read_raw(prof) -> Window:
    """The window read from the raw Kineto events: what prof.events() and
    prof.key_averages() give — the same filtered names, kernels linked to
    the op that launched them, the same nesting per thread, the same merge
    of a lone same-name child into its parent, the same float sums in the
    same order — without building torch's per-event Python objects, whose
    processing took 164.8 s of a 753-s run of chip_smoke.py (H100 80GB
    HBM3 at 700 W)."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _filter_name

    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    names = {}

    def rename(raw: str) -> str:  # torch's StringTable: demangled
        if raw not in names:
            names[raw] = torch._C._demangle(raw) if len(raw) > 1 else raw
        return names[raw]

    evs, frontend, linked = [], [], {}
    for k in res.events():
        raw = k.name()
        if _filter_name(raw) or getattr(k, "is_hidden_event", lambda: False)():
            continue
        start, end = (k.start_ns() - t0) / 1000, (k.end_ns() - t0) / 1000
        dev = k.device_type()
        if dev == DeviceType.CPU:
            ev = _CpuEv(rename(raw), start, end, k.start_thread_id(),
                        k.is_async() or k.start_thread_id() != k.end_thread_id())
        elif dev == DeviceType.CUDA:
            ev = Kernel(rename(raw), end - start)
        else:
            ev = None
        evs.append((start, -end, ev))
        corr = k.linked_correlation_id()
        if corr > 0:
            linked.setdefault(corr, []).append(ev)
        elif corr == 0 and isinstance(ev, _CpuEv):
            frontend.append((k.correlation_id(), ev))
    for cid, ev in frontend:
        if not ev.async_:
            for f in linked.get(cid, ()):
                if isinstance(f, Kernel):
                    ev.kernels.append(f.device_time)
                elif isinstance(f, _CpuEv):
                    f.thread = ev.thread
    evs.sort(key=lambda e: (e[0], e[1]))
    order = [e[2] for e in evs if e[2] is not None]
    cpu = [e for e in order if isinstance(e, _CpuEv)]
    # nesting: per thread, by (start, -end), a stack of open parents
    for _, group in itertools.groupby(sorted((e for e in cpu if not e.async_),
                                             key=lambda e: e.thread), key=lambda e: e.thread):
        stack = []
        for ev in group:
            while stack:
                parent = stack[-1]
                if ev.start >= parent.end or ev.end > parent.end:
                    stack.pop()
                else:
                    parent.children.append(ev)
                    ev.parent = parent
                    break
            stack.append(ev)
    # a lone child of its parent's name merges into it (kernels lifted)
    while True:
        gone = set()
        for i, ev in enumerate(cpu):
            p = ev.parent
            if p is not None and p.name == ev.name and len(p.children) == 1:
                p.children, p.kernels = ev.children, ev.kernels
                for ch in ev.children:
                    ch.parent = p
                gone.add(i)
        if not gone:
            break
        cpu = [ev for i, ev in enumerate(cpu) if i not in gone]
    ops = {}
    for ev in cpu:
        if ev.name.startswith("aten::"):
            row = ops.setdefault(ev.name, [0, 0])
            row[0] += 1
            if not ev.async_:
                row[1] += ev.device_total() - sum(ch.device_total() for ch in ev.children)
    return Window([e for e in order if isinstance(e, Kernel)], ops)


def _read_through_torch(prof) -> Window:
    """The same reading through torch's own processing (prof.events(),
    prof.key_averages())."""
    from torch.autograd import DeviceType

    kern = [Kernel(e.name, e.device_time) for e in prof.events()
            if e.device_type == DeviceType.CUDA]
    ops = {e.key: [e.count, e.self_device_time_total] for e in prof.key_averages()
           if e.key.startswith("aten::")}
    return Window(kern, ops)


def window_events(prof, through_torch: bool = False) -> Window:
    """A closed profiler window as its kernels, aten ops, launches and
    device ms.  The default reads the raw Kineto events;
    `through_torch=True` gives the same numbers through torch's own
    processing, at many times the cost (the cross-check).  The cyclic
    garbage collector is paused while the ~10^5 small objects of a
    reading are built: its passes over them took half of the reading's
    time."""
    was = gc.isenabled()
    gc.disable()
    try:
        return _read_through_torch(prof) if through_torch else _read_raw(prof)
    finally:
        if was:
            gc.enable()
