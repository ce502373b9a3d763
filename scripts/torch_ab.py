"""Time the port's runs from two checkouts on one card, in turns.

    python3 scripts/torch_ab.py OLD_ROOT NEW_ROOT [--cells handel,pingpong,dfinity,gsf,p2phandel]
                                [--rounds 1] [--byz-ms 300]

Each turn runs one checkout's `wittgenstein_tpu_torch` in a process of its
own (the package imports from that checkout's root, and its kernels build
there), in the order OLD, NEW, NEW, OLD, once per round, so that drift on
a shared host falls on both sides alike.  A turn drives the chosen cells
through the public entry points only:

  handel     flagship: make_handel(flagship_params(4096)), 16 replicas,
             1000 ms in 20-ms chunks with stop_when_done (chip_smoke.py's
             phase 5); byzantine: 4096 nodes, 1024 down,
             byzantine_suicide, 4 replicas, the first --byz-ms ms
  pingpong   make_pingpong(1000), 4096 replicas, 700 ms with
             stop_when_done (chip_smoke.py's phase 8)
  dfinity    make_dfinity(max_heights=64), 1024 replicas, 15000 ms
             (chip_smoke.py's phase 10)
  gsf        make_gsf(GSFSignatureParameters(node_count=2048)), 32
             replicas, 1000 ms in 20-ms chunks with stop_when_done
             (chip_smoke.py's gsf phase)
  p2phandel  make_p2phandel() at the reference defaults, 1024 replicas,
             up to 10000 ms in 20-ms chunks with stop_when_done
             (chip_smoke.py's p2phandel phase)

and prints one JSON line per run: wall ms per tick (lockstep Handel) or
per loop iteration (the event-driven cells), the hand-written kernels'
launches, and what must not differ between the checkouts (the lockstep
cells' done_at P10/P50/P90, PingPong's iterations and done ticks,
Dfinity's iterations and head heights).  The last line sums up each side's median.
Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

TURN = r"""
import json, sys, time
import numpy as np
import torch
from wittgenstein_tpu_torch.engine import replicate_state
from wittgenstein_tpu_torch.ops import kernels

def emit(cell, **out):
    print(json.dumps({"root": sys.argv[1], "cell": cell, **out,
                      "launches": {k.name: k.launches for k in kernels.KERNELS}}), flush=True)

def run(cell, params, replicas, ms, stop, make=None):
    net, state = (make or make_handel)(params)
    states = replicate_state(state, replicas)
    states = net.run_ms_batched(states, 1)  # first launches, builds and caches
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    done_t = ms - 1
    for _ in range((ms - 1) // 20):
        states = net.run_ms_batched(states, 20, stop)
    rest = (ms - 1) % 20
    if rest:
        states = net.run_ms_batched(states, rest, stop)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    done = states.done_at.cpu().numpy()
    down = states.down.cpu().numpy()
    live = done[~down]
    all_done = bool((np.where(down, 1, done) > 0).all())
    # the lockstep loop stops before the tick after the last completion
    ticks = int(done.max()) if (stop and all_done) else done_t
    fin = live[live > 0]
    q = np.percentile(fin, [10, 50, 90]).tolist() if fin.size else [None] * 3
    emit(cell, replicas=replicas, ticks=ticks, wall_s=wall, ms=wall / ticks * 1e3,
         done_at_p10_p50_p90=q)

def run_jumps(cell, make, replicas, ms, stop):
    net, state = make()
    # a short run on its own states first: builds the kernels, warms the
    # allocator
    net.run_ms_batched(replicate_state(state, replicas), 50, stop)
    states = replicate_state(state, replicas)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    states = net.run_ms_batched(states, ms, stop)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    it = net.jump_stats["iterations"]
    if cell == "pingpong":
        done = net.jump_stats["last_tick"].cpu().numpy()
        same = {"done_tick_p10_p50_p90": np.percentile(done, [10, 50, 90]).tolist(),
                "pong_min": int(states.proto["pong"][:, 0].min())}
    else:
        heads = net.protocol.head_height(states).cpu().numpy()
        same = {"head_min": int(heads.min()), "head_max": int(heads.max())}
    emit(cell, replicas=replicas, iterations=it, wall_s=wall, ms=wall / it * 1e3,
         dropped=int(states.dropped.sum()), **same)

cells = sys.argv[3].split(",")
if "handel" in cells:
    from wittgenstein_tpu_torch.protocols.handel import HandelParameters, flagship_params
    from wittgenstein_tpu_torch.protocols.handel_batched import make_handel
    run("flagship", flagship_params(4096), 16, 1000, True)
    run("byzantine", HandelParameters(node_count=4096, nodes_down=1024,
        threshold=int(3072 * 0.99), byzantine_suicide=True), 4, int(sys.argv[2]), False)
if "pingpong" in cells:
    from wittgenstein_tpu_torch.protocols.pingpong_batched import make_pingpong
    run_jumps("pingpong", lambda: make_pingpong(1000), 4096, 700, True)
if "dfinity" in cells:
    from wittgenstein_tpu_torch.protocols.dfinity_batched import make_dfinity
    run_jumps("dfinity", lambda: make_dfinity(max_heights=64), 1024, 15000, False)
if "gsf" in cells:
    from wittgenstein_tpu_torch.protocols.gsf import GSFSignatureParameters
    from wittgenstein_tpu_torch.protocols.gsf_batched import make_gsf
    run("gsf", GSFSignatureParameters(node_count=2048), 32, 1000, True, make=make_gsf)
if "p2phandel" in cells:
    from wittgenstein_tpu_torch.protocols.p2phandel_batched import make_p2phandel
    run("p2phandel", None, 1024, 10000, True, make=lambda _: make_p2phandel())
"""

CELLS = {"handel": ("flagship", "byzantine"), "pingpong": ("pingpong",),
         "dfinity": ("dfinity",), "gsf": ("gsf",), "p2phandel": ("p2phandel",)}
LOCKSTEP = ("flagship", "byzantine", "gsf", "p2phandel")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old_root")
    ap.add_argument("new_root")
    ap.add_argument("--cells", default="handel",
                    help="comma-separated, of " + ", ".join(CELLS))
    ap.add_argument("--rounds", type=int, default=1, help="rounds of OLD, NEW, NEW, OLD")
    ap.add_argument("--byz-ms", type=int, default=300)
    args = ap.parse_args()
    chosen = args.cells.split(",")
    if not set(chosen) <= set(CELLS):
        ap.error(f"--cells: one of {', '.join(CELLS)}")
    roots = {"old": os.path.abspath(args.old_root), "new": os.path.abspath(args.new_root)}
    runs = []
    for side in ("old", "new", "new", "old") * args.rounds:
        root = roots[side]
        env = dict(os.environ, PYTHONPATH=root)
        out = subprocess.run(
            [sys.executable, "-c", TURN, side, str(args.byz_ms), args.cells], cwd=root, env=env,
            capture_output=True, text=True, timeout=1800,
        )
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        for line in out.stdout.splitlines():
            if line.startswith("{"):
                print(line, flush=True)
                runs.append(json.loads(line))
    summary = {}
    for side in ("old", "new"):
        for cell in (c for name in chosen for c in CELLS[name]):
            ms = [r["ms"] for r in runs if r["root"] == side and r["cell"] == cell]
            unit = "tick" if cell in LOCKSTEP else "iteration"
            summary[f"{side}_{cell}_ms_per_{unit}"] = statistics.median(ms)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
