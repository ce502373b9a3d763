"""Fault sweep and adversary search from the command line, on the port.

    python -m wittgenstein_tpu_torch.tools.fault_sweep [out_dir] [--device cpu|cuda]
    python -m wittgenstein_tpu_torch.tools.fault_sweep [out_dir] --search
        [--protocol p2pflood] [--objective done_at] [--optimizer es|random|sha]
        [--generations N] [--population N] [--sim-ms MS] [--seed N]
        [--pin PATH] [--device cpu|cuda]

The default device is CUDA (it raises without a card); `--device cpu`
runs the plain versions.

The static mode builds P2PFlood at the reference defaults and runs the
five static plans — a fault-free control, a 20% crash at 200 ms, a
two-way partition window, probabilistic drop, and latency inflation —
as replica rows of ONE `run_ms_batched` run over 1500 ms.  It writes an
availability-vs-latency report (`report.txt`) and a JSONL run record
(`run_records.jsonl`), and fails if the sweep misbehaves: the control
row must equal a fault-free single run in every leaf, the crash row
must lose availability, and the drop and inflation counters must show
that their lanes fired.

`--search` runs a resumable adversary search (`search.SearchDriver`):
each generation is one batched sweep, the optimizer state checkpoints
under `<out_dir>/checkpoints`, and the run writes a frontier report
(`report.json`); interrupted and re-invoked with the same arguments, it
resumes.  `--pin` writes the champion as a replayable regression pin.
The last line printed is one JSON object with `"ok": true`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from ..engine import replicate_state
from ..interop import state_to_numpy
from ..protocols.p2pflood import P2PFloodParameters
from ..protocols.p2pflood_batched import make_p2pflood
from ..scenarios.sweep import run_fault_sweep
from ..search import SearchConfig, SearchDriver, static_baseline_plans
from ..telemetry import RunRecordWriter

SIM_MS = 1500
SEED0 = 0


def run_search(argv, out_dir: str, device) -> int:
    """--search mode (module docstring)."""
    p = argparse.ArgumentParser(prog="fault_sweep --search")
    p.add_argument("--protocol", default="p2pflood")
    p.add_argument("--objective", default="done_at")
    p.add_argument("--optimizer", default="es", choices=("es", "random", "sha"))
    p.add_argument("--generations", type=int, default=3)
    p.add_argument("--population", type=int, default=8)
    p.add_argument("--sim-ms", type=int, default=SIM_MS)
    p.add_argument("--seed", type=int, default=SEED0)
    p.add_argument("--pin", default=None, help="also pin the champion to this regression path")
    args = p.parse_args(argv)

    cfg = SearchConfig(
        protocol=args.protocol,
        objective=args.objective,
        sim_ms=args.sim_ms,
        generations=args.generations,
        population=args.population,
        seed=args.seed,
        optimizer=args.optimizer,
        checkpoint_dir=os.path.join(out_dir, "checkpoints"),
        label=f"{args.protocol}-{args.optimizer}-s{args.seed}",
    )
    driver = SearchDriver(cfg, device=device)
    if driver.generation:
        print(f"resuming at generation {driver.generation}")
    report = driver.run()
    with open(os.path.join(out_dir, "report.json"), "w") as f:
        json.dump(report, f, indent=2, sort_keys=True, default=float)
    if args.pin:
        driver.pin_champion(args.pin)
    champ = report["champion"]
    print(json.dumps({
        "ok": True,
        "out_dir": out_dir,
        "generations": driver.generation,
        "champion_score": champ["score"] if champ else None,
        "frontier_size": len(report["frontier"]),
        "pinned": args.pin,
    }))
    return 0


def _leaf_pairs(a, b, prefix=""):
    """(name, leaf of a, leaf of b) over two numpy state trees."""
    for k, va in a.items():
        if isinstance(va, dict):
            yield from _leaf_pairs(va, b[k], f"{prefix}{k}.")
        elif isinstance(va, np.ndarray):
            yield prefix + k, va, b[k]


def run_static(out_dir: str, device) -> int:
    """The static 5-plan sweep and its checks (module docstring)."""
    net, state = make_p2pflood(P2PFloodParameters(), capacity=2048, seed=SEED0, device=device)
    plans = static_baseline_plans(net, state)
    out, records = run_fault_sweep(net, state, plans, sim_ms=SIM_MS, seed0=SEED0,
                                   done_cdf_every=100)

    # the control row (row 0, seed SEED0) equals a fault-free run of one
    # replica at that seed
    single = state_to_numpy(net.run_ms_batched(replicate_state(state, 1, seeds=[SEED0]), SIM_MS))
    swept = state_to_numpy(out)
    swept.pop("faults")
    for name, a, b in _leaf_pairs(single, swept):
        assert np.array_equal(a, b[:1]), f"control row diverged from fault-free run on {name}"

    by_label = {r["plan"]["label"]: r for r in records}
    ctrl = by_label["control"]
    assert ctrl["availability"] == 1.0, f"control did not finish: {ctrl}"
    assert sum(ctrl["dropped_by_fault"]) == 0 and sum(ctrl["delayed_by_fault"]) == 0
    crash = by_label["crash20@200"]
    assert crash["availability"] < ctrl["availability"], (
        f"crash plan lost no availability: {crash}"
    )
    assert sum(by_label["drop30%"]["dropped_by_fault"]) > 0
    assert sum(by_label["slow3x"]["delayed_by_fault"]) > 0

    lines = [
        f"fault sweep: p2pflood n={net.n_nodes}, sim_ms={SIM_MS}, "
        f"{len(plans)} plans x 1 replica, one run_ms_batched run on {net.device.type}",
        "",
        f"{'plan':<16} {'avail':>6} {'done p50':>9} {'done p90':>9} "
        f"{'dropped':>8} {'delayed':>8}",
    ]
    for r in records:
        q = r["done_at_ms"] or {"p50": -1, "p90": -1}
        lines.append(
            f"{r['plan']['label']:<16} {r['availability']:>6.2f} "
            f"{q['p50']:>9} {q['p90']:>9} "
            f"{sum(r['dropped_by_fault']):>8} {sum(r['delayed_by_fault']):>8}"
        )
    report = "\n".join(lines) + "\n"
    with open(os.path.join(out_dir, "report.txt"), "w") as f:
        f.write(report)
    print(report)

    RunRecordWriter(os.path.join(out_dir, "run_records.jsonl")).write(
        {"kind": "fault_sweep", "records": records},
        sim_ms=SIM_MS,
        nodes=net.n_nodes,
        plans=len(plans),
    )
    print(json.dumps({
        "ok": True,
        "out_dir": out_dir,
        "plans": len(plans),
        "availability": {r["plan"]["label"]: r["availability"] for r in records},
    }))
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    out_dir = argv.pop(0) if argv and not argv[0].startswith("-") else "fault_sweep"
    os.makedirs(out_dir, exist_ok=True)
    if "--search" in argv:
        argv.remove("--search")
        return run_search(argv, out_dir, device)
    return run_static(out_dir, device)


if __name__ == "__main__":
    sys.exit(main())
