"""The paths chip_smoke.py runs at a cut depth, run on one GPU at their full
depth, each replica 0 held to the JAX package's seed-0 run there.

    python3 scripts/torch_full_depth.py [--paths ethpow,p2phandel,...]

To fit its time limit, chip_smoke.py runs ETHPoW for 150 000 ms (the
reference's try_miner runs an hour; 600 000 ms before the cut), P2PHandel
for 1000 ms (3000 before), HandelEth2 for 1200 (2000), SanFermin for 1200
(2200) and SanFerminCappos for 500 (1000), each replica 0 pinned at the
cut depth.  This script builds the kernels, then runs each of those paths
as chip_smoke.py's phase builds it (the same configuration and replica
count) at the full depth, and holds replica 0, read by chip_smoke.py's
own readers, to FULL_R0: the JAX package's seed-0 numbers at that depth
from `scripts/torch_r0_reference.py <path> --ms <depth>` on the CPU.
ETHPoW also tracks every threshold's argument, which must stay inside
the range where the port's exp is XLA's bit for bit.  It prints the
card's name and power limit, one JSON line a path (ticks or iterations,
wall seconds, ms each, hand-written kernel launches, replica 0, equal or
not), and exits non-zero if a replica 0 differs or a path fails.  Takes
a few minutes; imports nothing of JAX.
"""

from __future__ import annotations

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from wittgenstein_tpu_torch.engine import replicate_state  # noqa: E402
from wittgenstein_tpu_torch.ops import kernels  # noqa: E402
from wittgenstein_tpu_torch.protocols.ethpow import ETHPoWParameters  # noqa: E402
from wittgenstein_tpu_torch.protocols.ethpow_batched import (  # noqa: E402
    EXP_COVERED,
    BatchedEthPow,
    replicate_ethpow,
)
from wittgenstein_tpu_torch.protocols.handeleth2 import HandelEth2Parameters  # noqa: E402
from wittgenstein_tpu_torch.protocols.handeleth2_batched import make_handeleth2  # noqa: E402
from wittgenstein_tpu_torch.protocols.p2phandel_batched import make_p2phandel  # noqa: E402
from wittgenstein_tpu_torch.protocols.sanfermin_batched import make_sanfermin  # noqa: E402
from wittgenstein_tpu_torch.protocols.sanfermin_cappos import SanFerminParameters  # noqa: E402
from wittgenstein_tpu_torch.protocols.sanfermin_cappos_batched import (  # noqa: E402
    make_sanfermin_cappos,
)

FULL_MS = {"ethpow": 600_000, "p2phandel": 3000, "handeleth2": 2000, "sanfermin": 2200,
           "cappos": 1000}
# the JAX package's seed-0 replica 0 at FULL_MS (scripts/torch_r0_reference.py)
FULL_R0 = {
    "ethpow": {
        "honest": {"n_blocks": 59, "chain": 58, "tip": 58, "revenue_ratio": 0.05172413793103448,
                   "blocks_mined": [7, 3, 6, 5, 8, 6, 9, 3, 7, 4], "overflowed": 0},
        "selfish": {"n_blocks": 69, "chain": 46, "tip": 68, "revenue_ratio": 0.6304347826086957,
                    "blocks_mined": [4, 29, 4, 5, 5, 6, 6, 2, 5, 2], "overflowed": 0},
        "selfish2": {"n_blocks": 69, "chain": 46, "tip": 68, "revenue_ratio": 0.6304347826086957,
                     "blocks_mined": [4, 29, 4, 5, 5, 6, 6, 2, 5, 2], "overflowed": 0},
    },
    "p2phandel": {"msg_received": 332, "msg_sent": 332, "done": 0, "verified": 787,
                  "ver_card": 787, "ver_sig": 343, "peers_state": 1392, "ver_done_t": 202486,
                  "last_check": 181686},
    "handeleth2": {"msg_received": 21711, "msg_sent": 21960, "rr_bump": 21711, "window_min": 128,
                   "window_max": 128},
    "sanfermin": {"done": 4078, "thr_at_p10_p50_p90": [1044, 1260, 1580], "thr_at_min": 815,
                  "thr_at_max": 2109, "msg_received": 156424, "sent_req": 91655},
    "cappos": {"done": 1018, "not_done": [311, 390, 534, 674, 841, 890],
               "done_at_p10_p50_p90": [323.0, 334.0, 346.0], "done_at_min": 313,
               "done_at_max": 358, "thr_done": 1018, "thr_at_p10_p50_p90": [308.0, 320.0, 332.0],
               "msg_received": 402698, "msg_sent": 402698, "cpl": 47},
}


def _lockstep(path: str, make, replicas: int, read) -> dict:
    """A per-ms path at its full depth, as its chip_smoke phase builds it:
    run_ms_batched(FULL_MS) with the launch counts zeroed just before."""
    ms = FULL_MS[path]
    net, state = make()
    states = replicate_state(state, replicas)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    states = net.run_ms_batched(states, ms)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"path": path, "ms": ms, "replicas": replicas, "ticks": ms, "wall_s": wall,
            "ms_per_tick": wall / ms * 1e3, "dropped": int(states.dropped.sum()),
            "launches": {k.name: k.launches for k in kernels.KERNELS},
            "replica0": read(states)}


def _ethpow() -> dict:
    """ETHPoW's three configurations as the ethpow phase builds them, at
    FULL_MS with the thresholds' arguments tracked on the card."""
    ms = FULL_MS["ethpow"]
    out = {"path": "ethpow", "ms": ms, "replicas": cs.ETH_REPLICAS, "configs": {},
           "replica0": {}}
    lo = hi = None
    for config, kw in cs.ETH_CONFIGS.items():
        net = BatchedEthPow(ETHPoWParameters(number_of_miners=cs.ETH_MINERS, **kw),
                            b_max=cs.ETH_B_MAX)
        seen = []

        def thresholds(cand_diff, net=net, seen=seen):
            x = -net.hp_per_10ms / cand_diff
            seen.append(torch.stack([x.amin(), x.amax()]))
            return BatchedEthPow.thresholds(net, cand_diff)

        net.thresholds = thresholds
        states = replicate_ethpow(net.init_state(), cs.ETH_REPLICAS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states = net.run_ms(states, ms)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        x = torch.stack(seen)
        lo = x[:, 0].min() if lo is None else torch.minimum(lo, x[:, 0].min())
        hi = x[:, 1].max() if hi is None else torch.maximum(hi, x[:, 1].max())
        ch = cs.ethpow_chain(states)
        s0 = {f: getattr(states, f)[0].cpu().numpy() for f in ("n_blocks", "blocks_mined",
                                                                "overflowed")}
        out["replica0"][config] = {
            "n_blocks": int(s0["n_blocks"]), "chain": int(ch["chain"][0]),
            "tip": int(ch["tip"][0]), "revenue_ratio": int(ch["mine"][0]) / int(ch["chain"][0]),
            "blocks_mined": s0["blocks_mined"].tolist(), "overflowed": int(s0["overflowed"])}
        it = net.jump_stats["iterations"]
        out["configs"][config] = {"iterations": it, "wall_s": wall,
                                  "ms_per_iteration": wall / it * 1e3,
                                  "overflowed": int(states.overflowed.sum())}
        del net, states
    x_min, x_max = float(lo), float(hi)
    out["x_range"] = [x_min, x_max]
    out["x_inside_covered"] = EXP_COVERED[0] <= -x_max and -x_min < EXP_COVERED[1]
    out["wall_s"] = sum(c["wall_s"] for c in out["configs"].values())
    return out


PATHS = {
    "ethpow": _ethpow,
    "p2phandel": lambda: _lockstep("p2phandel", make_p2phandel, cs.P2P_REPLICAS,
                                   cs.p2p_replica0),
    "handeleth2": lambda: _lockstep(
        "handeleth2", lambda: make_handeleth2(HandelEth2Parameters(node_count=cs.ETH2_NODES)),
        cs.ETH2_REPLICAS, cs.eth2_replica0),
    "sanfermin": lambda: _lockstep(
        "sanfermin", lambda: make_sanfermin(cs.sf_params(cs.SF_NODES), capacity=cs.SF_CAPACITY),
        cs.SF_REPLICAS, cs.sf_replica0),
    "cappos": lambda: _lockstep(
        "cappos", lambda: make_sanfermin_cappos(SanFerminParameters(1024, 512, 2, 48, 150, 50),
                                                capacity=cs.CAPPOS_CAPACITY),
        cs.CAPPOS_REPLICAS, cs.cappos_replica0),
}


@torch.inference_mode()
def main(argv) -> int:
    paths = argv[argv.index("--paths") + 1].split(",") if "--paths" in argv else list(PATHS)
    if not set(paths) <= set(PATHS):
        raise SystemExit(f"torch_full_depth: --paths takes some of {','.join(PATHS)}")
    info = cs.device_info()
    cs.build()
    bad = []
    for path in paths:
        row = PATHS[path]()
        row["equal"] = row["replica0"] == FULL_R0[path]
        cs.emit(row)
        if not row["equal"]:
            bad.append(path)
        if row.get("dropped") or any(c["overflowed"] for c in row.get("configs", {}).values()):
            bad.append(f"{path} (dropped or overflowed)")
    cs.emit({"full_depth": {p: FULL_MS[p] for p in paths}, "differ": bad,
             "device": {"kind": info["kind"], "nvidia_smi": info["nvidia_smi"]}})
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
