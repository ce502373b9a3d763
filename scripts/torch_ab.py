"""Time the port's Handel runs from two checkouts on one card, in turns.

    python3 scripts/torch_ab.py OLD_ROOT NEW_ROOT [--byz-ms 300]

Each turn runs one checkout's `wittgenstein_tpu_torch` in a process of its
own (the package imports from that checkout's root, and its kernels build
there), in the order OLD, NEW, NEW, OLD, so that drift on a shared host
falls on both sides alike.  A turn drives, through the public entry
points only:

  flagship   make_handel(flagship_params(4096)), 16 replicas, 1000 ms in
             20-ms chunks with stop_when_done (chip_smoke.py's phase 5)
  byzantine  4096 nodes, 1024 down, byzantine_suicide, 4 replicas, the
             first --byz-ms ms

and prints one JSON line per run: wall ms per tick, ticks, the hand-written
kernels' launches, and the flagship's done_at P10/P50/P90 (which must not
differ between the checkouts).  The last line sums up each side's median.
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
from wittgenstein_tpu_torch.protocols.handel import HandelParameters, flagship_params
from wittgenstein_tpu_torch.protocols.handel_batched import make_handel

def run(cell, params, replicas, ms, stop):
    net, state = make_handel(params)
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
    print(json.dumps({"root": sys.argv[1], "cell": cell, "replicas": replicas,
                      "ticks": ticks, "wall_s": wall, "ms_per_tick": wall / ticks * 1e3,
                      "launches": {k.name: k.launches for k in kernels.KERNELS},
                      "done_at_p10_p50_p90": q}), flush=True)

run("flagship", flagship_params(4096), 16, 1000, True)
run("byzantine", HandelParameters(node_count=4096, nodes_down=1024,
    threshold=int(3072 * 0.99), byzantine_suicide=True), 4, int(sys.argv[2]), False)
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old_root")
    ap.add_argument("new_root")
    ap.add_argument("--byz-ms", type=int, default=300)
    args = ap.parse_args()
    roots = {"old": os.path.abspath(args.old_root), "new": os.path.abspath(args.new_root)}
    runs = []
    for side in ("old", "new", "new", "old"):
        root = roots[side]
        env = dict(os.environ, PYTHONPATH=root)
        out = subprocess.run(
            [sys.executable, "-c", TURN, side, str(args.byz_ms)], cwd=root, env=env,
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
        for cell in ("flagship", "byzantine"):
            ms = [r["ms_per_tick"] for r in runs if r["root"] == side and r["cell"] == cell]
            summary[f"{side}_{cell}_ms_per_tick"] = statistics.median(ms)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
