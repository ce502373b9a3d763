"""What the telemetry side-car costs the flagship Handel and PingPong.

    python3 scripts/torch_telemetry_cost.py            # on the card
    python3 scripts/torch_telemetry_cost.py --cpu-aten # on the CPU

On the card (one GPU, from the repo root) it prints the card's name and
power limit, builds the kernels and times, in turns in one process
(plain, instrumented, instrumented, plain): the plain flagship
(`flagship_params(4096)`, R = 16, 20-ms chunks with stop_when_done, as
chip_smoke's flagship phase drives it) and the instrumented one
(`TelemetryConfig(128, 10)`) the same way, and between them the
instrumented flagship on replicas 0-3 for exactly the plain run's
executed ticks without the stop test (chip_smoke's telemetry phase),
twice; then what a
10-tick torch.profiler window of the plain flagship costs to close and
to read (chip_smoke's `_window_events`, with the garbage collector on
and paused).  With --cpu-aten it counts, on the CPU, the aten calls a
tick of flagship_params(256) x 4 (20 ticks after 100) and an iteration
of PingPong 1000 x 4 (200 ms after 100), with and without telemetry.
Each measurement prints one JSON line.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from wittgenstein_tpu_torch.engine import replicate_state  # noqa: E402
from wittgenstein_tpu_torch.protocols.handel import flagship_params  # noqa: E402
from wittgenstein_tpu_torch.protocols.handel_batched import make_handel  # noqa: E402
from wittgenstein_tpu_torch.protocols.pingpong_batched import make_pingpong  # noqa: E402
from wittgenstein_tpu_torch.telemetry import TelemetryConfig  # noqa: E402

CFG = TelemetryConfig(snapshots=128, snapshot_every_ms=10)
SIM_MS, CHUNK_MS = 1000, 20


def flagship_run(replicas: int, tele: bool, ticks=None) -> dict:
    """The flagship at `replicas`, in CHUNK_MS chunks with the stop test,
    or for exactly `ticks` ticks without it; host wall ms a tick."""
    net, state = make_handel(flagship_params(4096), telemetry=CFG if tele else None)
    states = replicate_state(state, replicas)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if ticks is None:
        for _ in range(SIM_MS // CHUNK_MS):
            states = net.run_ms_batched(states, CHUNK_MS, True)
    else:
        states = net.run_ms_batched(states, ticks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = int(states.done_at.max()) + 1 if ticks is None else ticks
    return {"replicas": replicas, "telemetry": tele, "stop_test": ticks is None, "ticks": n,
            "wall_s": wall, "ms_per_tick": wall / n * 1e3}


def window_cost() -> dict:
    """Close and read a 10-tick profile window of the plain flagship."""
    import chip_smoke
    from torch.profiler import ProfilerActivity, profile

    net, state = make_handel(flagship_params(4096))
    states = net.run_ms_batched(replicate_state(state, 16), 100)
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    net.run_ms_batched(states, 10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof.__exit__(None, None, None)
    t1 = time.perf_counter()
    n = len(prof.profiler.kineto_results.events())
    t2 = time.perf_counter()
    chip_smoke._window_events(prof)
    t3 = time.perf_counter()
    with chip_smoke._gc_paused():
        chip_smoke._window_events(prof)
    t4 = time.perf_counter()
    return {"window_events": n, "close_s": t1 - t0, "events_s": t2 - t1,
            "read_s": t3 - t2, "read_gc_paused_s": t4 - t3}


def cpu_aten() -> None:
    from torch.profiler import ProfilerActivity, profile

    def count(fn) -> int:
        with profile(activities=[ProfilerActivity.CPU]) as p:
            fn()
        return sum(1 for e in p.events() if e.name.startswith("aten::"))

    for tele in (None, CFG):
        net, st = make_handel(flagship_params(256), telemetry=tele, device="cpu")
        s = net.run_ms_batched(replicate_state(st, 4), 100)
        n = count(lambda: net.run_ms_batched(s, 20))
        print(json.dumps({"path": "flagship_params(256) x 4", "telemetry": tele is not None,
                          "aten_calls_per_tick": n / 20}), flush=True)
    for tele in (None, CFG):
        net, st = make_pingpong(1000, telemetry=tele, device="cpu")
        s = net.run_ms_batched(replicate_state(st, 4), 100)
        n = count(lambda: net.run_ms_batched(s, 200))
        it = net.jump_stats["iterations"]
        print(json.dumps({"path": "pingpong 1000 x 4", "telemetry": tele is not None,
                          "aten_calls_per_iteration": n / it, "iterations": it}), flush=True)


def main(argv) -> int:
    if "--cpu-aten" in argv:
        cpu_aten()
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("torch_telemetry_cost: no CUDA device")
    from wittgenstein_tpu_torch.ops import kernels

    import subprocess

    kernels.build_all()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip(), flush=True)
    plain = flagship_run(16, False)
    print(json.dumps(plain), flush=True)
    for replicas, ticks in ((16, None), (4, plain["ticks"]), (4, plain["ticks"]), (16, None)):
        print(json.dumps(flagship_run(replicas, True, ticks)), flush=True)
    print(json.dumps(flagship_run(16, False)), flush=True)
    print(json.dumps(window_cost()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
