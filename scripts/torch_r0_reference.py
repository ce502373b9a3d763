"""The JAX package's replica-0 numbers that chip_smoke.py pins, computed
on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/torch_r0_reference.py byzantine --point 5 --out r.json
    JAX_PLATFORMS=cpu python3 scripts/torch_r0_reference.py cities --out c.json
    JAX_PLATFORMS=cpu python3 scripts/torch_r0_reference.py ethpow --ms 300000 --out e.json
    JAX_PLATFORMS=cpu python3 scripts/torch_r0_reference.py p2phandel --ms 1000 --out p.json
    JAX_PLATFORMS=cpu python3 scripts/torch_r0_reference.py durable --ms 400 --out d.json
    JAX_PLATFORMS=cpu python3 scripts/torch_r0_reference.py serve --out s.json
    JAX_PLATFORMS=cpu python3 scripts/torch_r0_reference.py throughput --ms 700 --out t.json
    JAX_PLATFORMS=cpu python3 scripts/torch_r0_reference.py anim --ms 3000 --out a.json

`byzantine`: point i of BASELINE config 3's sweep, (0.0, 0.05, 0.10,
0.15, 0.20, 0.25) Byzantine at 4096 nodes under `default_params`, is
row 0 of its run_sweep group, seed 1000 * i (`--row r`: row r, seed
1000 * i + r).  The group stops at the tick after its last replica's
completion, which only the whole group knows, so the script steps the
row alone one tick at a time and writes its BasicStats after every tick
from its first completion on, up to `--after` times that depth or
`--max-ms` (`{"depth": stats}`; `final` at the last depth in any case):
the card's stop tick then picks the entry; `undone` counts the live
nodes not done at the last depth (SWEEP_R0, SWEEP_UNDONE).
`cities`: the allScenarios "111" corner at levelWaitTime 50
(`log_start_time_configs(4096, dead=0.2, tor=0.2)[2]`), seed 0, run
`--ms` (300) ms: its done count and its msg_received, msg_filtered and
sigs_checked sums (CITIES_R0).
`ethpow`: the ethpow phase's three configurations (10 miners, b_max
512), seed 0, run `--ms` ms, read as chip_smoke.py reads replica 0
(ETH_R0): the JAX state goes through the port's interop and
chip_smoke's `ethpow_chain`.  `p2phandel`, `sanfermin`, `handeleth2`,
`cappos`: the phase's configuration, seed 0, run `--ms` ms, read by
chip_smoke's `p2p_replica0`, `sf_replica0`, `eth2_replica0`,
`cappos_replica0` (P2P_R0, SF_R0, ETH2_R0, CAPPOS_R0;
handeleth2 also counts the nodes short of a full aggregate).
`durable`: the durable phase's control row, the flagship at 4096 nodes
with TELE_CFG and the score cache (the card's default) through
run_fault_sweep at seed 0 for `--ms` (400) ms,
read by chip_smoke's `durable_replica0` (DURABLE_R0), with its record.
`anim`: HandelScenarios.genAnim's run (128 nodes, a frame every 10 ms)
for `--ms` ms as the JAX package's gen_anim runs it, its frames (each
live node's id, position, signatures held and done flag) summarized by
chip_smoke's `anim_summary` (ANIM_R0 at 3000 ms).
`serve`: every job of chip_smoke's serve phase (`serve_jobs()`: BASELINE
config 1's PingPong under each fault op, the two flagship Handel jobs,
the preemptor) through the JAX package's `BatchScheduler.run_singleton`,
Handel built with the score cache on (the card's default): the state
digest of each (SERVE_R0; `--ms` is unused; ~10 min).  `throughput`:
the throughput phase's PingPong (1000 nodes, 4096-byte messages, the
Mathis model, the discard time), seed 0, `--ms` (700) ms with
stop_when_done, read by chip_smoke's `thru_replica0` (THRU_R0, its state
digest among the numbers).  Imports the JAX
package, and for these readers the port's interop.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from wittgenstein_tpu.engine import stack_states  # noqa: E402
from wittgenstein_tpu.protocols.handel_batched import make_handel  # noqa: E402
from wittgenstein_tpu.scenarios.handel_scenarios import log_start_time_configs  # noqa: E402
from wittgenstein_tpu.scenarios.sweep import default_params  # noqa: E402

BYZ_FRACTIONS = (0.0, 0.05, 0.10, 0.15, 0.20, 0.25)


def _row0(params, seed: int):
    net, st = make_handel(params)
    return net, stack_states([st._replace(seed=st.seed * 0 + seed)])


def _stats(out) -> dict:
    """run_sweep's BasicStats over row 0's live nodes."""
    live = ~np.asarray(out.down)[0]
    d = np.asarray(out.done_at)[0][live]
    r = np.asarray(out.msg_received)[0][live]
    return {
        "done_at_min": int(d.min()), "done_at_avg": int(d.mean()), "done_at_max": int(d.max()),
        "msg_rcv_min": int(r.min()), "msg_rcv_avg": int(r.mean()), "msg_rcv_max": int(r.max()),
        "msg_filtered_avg": int(np.asarray(out.proto["msg_filtered"])[0][live].mean()),
        "sigs_checked_avg": int(np.asarray(out.proto["sigs_checked"])[0][live].mean()),
    }


def byzantine(nodes: int, point: int, row: int, max_ms: int, after: float) -> dict:
    dr = BYZ_FRACTIONS[point]
    seed = 1000 * point + row
    net, s = _row0(default_params(nodes, dead_ratio=dr, byzantine_suicide=dr > 0), seed)
    by_depth = {}
    t0 = time.time()
    for depth in range(1, max_ms + 1):
        s = net.run_ms_batched(s, 1, False)
        done = np.asarray(s.done_at)[0]
        live = ~np.asarray(s.down)[0]
        if (done[live] > 0).all():
            by_depth[depth] = _stats(s)
            if depth >= after * min(by_depth):
                break
    live = ~np.asarray(s.down)[0]
    undone = int((np.asarray(s.done_at)[0][live] == 0).sum())
    return {"point": point, "row": row, "dead_ratio": dr, "nodes": nodes, "seed": seed,
            "depth": depth, "undone": undone, "seconds": time.time() - t0, "final": _stats(s),
            "by_depth": by_depth}


def cities(nodes: int, ms: int) -> dict:
    cfg = log_start_time_configs(nodes, dead=0.2, tor=0.2)[2]
    net, s = _row0(cfg.params, 0)
    t0 = time.time()
    s = net.run_ms_batched(s, ms, False)
    return {"nodes": nodes, "ms": ms, "seconds": time.time() - t0,
            "done": int((np.asarray(s.done_at)[0] > 0).sum()),
            "msg_received": int(np.asarray(s.msg_received)[0].astype(np.int64).sum()),
            "msg_filtered": int(np.asarray(s.proto["msg_filtered"])[0].astype(np.int64).sum()),
            "sigs_checked": int(np.asarray(s.proto["sigs_checked"])[0].astype(np.int64).sum())}


def ethpow(ms: int) -> dict:
    import chip_smoke as cs
    from wittgenstein_tpu.protocols import ethpow_batched as jeth
    from wittgenstein_tpu.protocols.ethpow import ETHPoWParameters
    from wittgenstein_tpu_torch.interop import state_from_numpy

    out = {"ms": ms}
    for config, kw in cs.ETH_CONFIGS.items():
        net = jeth.BatchedEthPow(ETHPoWParameters(number_of_miners=cs.ETH_MINERS, **kw),
                                 b_max=cs.ETH_B_MAX)
        s = net.run_ms_batched(jeth.replicate_ethpow(net.init_state(), 1), ms)
        leaves = {f.name: np.asarray(getattr(s, f.name)) for f in dataclasses.fields(s)}
        t = state_from_numpy(leaves, "cpu")
        ch = cs.ethpow_chain(t)
        out[config] = {"n_blocks": int(t.n_blocks[0]), "chain": int(ch["chain"][0]),
                       "tip": int(ch["tip"][0]),
                       "revenue_ratio": int(ch["mine"][0]) / int(ch["chain"][0]),
                       "blocks_mined": t.blocks_mined[0].tolist(),
                       "overflowed": int(t.overflowed[0])}
    return out


def _port_state(make, ms: int):
    """The JAX package's seed-0 run of `make()` for `ms` ms, as the port's
    SimState on the CPU, for chip_smoke's readers."""
    from wittgenstein_tpu.engine import replicate_state
    from wittgenstein_tpu_torch.interop import state_from_numpy

    net, state = make()
    s = net.run_ms_batched(replicate_state(state, 1), ms)
    leaves = {k: v if isinstance(v, tuple) else np.asarray(v)
              for k, v in s._asdict().items() if k != "proto"}
    leaves["proto"] = {k: np.asarray(v) for k, v in s.proto.items()}
    return state_from_numpy(leaves, "cpu")


def p2phandel(ms: int) -> dict:
    import chip_smoke as cs
    from wittgenstein_tpu.protocols.p2phandel_batched import make_p2phandel

    return {"ms": ms, "replica0": cs.p2p_replica0(_port_state(make_p2phandel, ms))}


def sanfermin(ms: int) -> dict:
    import chip_smoke as cs
    from wittgenstein_tpu.protocols.sanfermin import SanFerminSignatureParameters
    from wittgenstein_tpu.protocols.sanfermin_batched import make_sanfermin

    n = cs.SF_NODES
    state = _port_state(lambda: make_sanfermin(
        SanFerminSignatureParameters(n, n, 2, 48, 300, 1, False, None, None),
        capacity=cs.SF_CAPACITY), ms)
    return {"ms": ms, "replica0": cs.sf_replica0(state), "dropped": int(state.dropped.sum())}


def handeleth2(ms: int) -> dict:
    import chip_smoke as cs
    from wittgenstein_tpu.protocols.handeleth2 import HandelEth2Parameters
    from wittgenstein_tpu.protocols.handeleth2_batched import make_handeleth2

    state = _port_state(lambda: make_handeleth2(HandelEth2Parameters(node_count=cs.ETH2_NODES)),
                        ms)
    cards = cs.eth2_cards(state)
    return {"ms": ms, "replica0": cs.eth2_replica0(state),
            "nodes_short": int((cards != cs.ETH2_NODES).sum())}


def cappos(ms: int) -> dict:
    import chip_smoke as cs
    from wittgenstein_tpu.protocols.sanfermin_cappos import SanFerminParameters
    from wittgenstein_tpu.protocols.sanfermin_cappos_batched import make_sanfermin_cappos

    state = _port_state(lambda: make_sanfermin_cappos(
        SanFerminParameters(1024, 512, 2, 48, 150, 50), capacity=cs.CAPPOS_CAPACITY), ms)
    return {"ms": ms, "replica0": cs.cappos_replica0(state), "dropped": int(state.dropped.sum())}


def durable(ms: int) -> dict:
    """Row 0 of the durable phase's sweep: the flagship with TELE_CFG, the
    control plan at seed 0, through the JAX package's run_fault_sweep."""
    import chip_smoke as cs
    from wittgenstein_tpu.profiling.ablation import flagship_params
    from wittgenstein_tpu.scenarios.sweep import run_fault_sweep
    from wittgenstein_tpu.telemetry.state import TelemetryConfig
    from wittgenstein_tpu_torch.interop import state_from_numpy

    tele = TelemetryConfig(snapshots=cs.TELE_CFG.snapshots,
                           snapshot_every_ms=cs.TELE_CFG.snapshot_every_ms)
    # score_cache on, as the port's make_handel has it on the card: the
    # four cache leaves are in the row's digest
    net, state = make_handel(flagship_params(cs.FLAGSHIP_NODES), telemetry=tele,
                             score_cache=True)
    out, records = run_fault_sweep(net, state, [None], ms)
    leaves = {k: v if isinstance(v, tuple) else np.asarray(v)
              for k, v in out._asdict().items() if k != "proto"}
    leaves["proto"] = {k: np.asarray(v) for k, v in out.proto.items()}
    return {"ms": ms, "replica0": cs.durable_replica0(state_from_numpy(leaves, "cpu")),
            "record": records[0]}


def throughput(ms: int) -> dict:
    """Replica 0 of the throughput phase: BASELINE config 1's PingPong,
    built as make_pingpong builds it, with every message THRU_SIZE bytes
    under the JAX package's Mathis model and THRU_DISCARD_MS, seed 0, `--ms` (700) ms with stop_when_done, read by
    chip_smoke's `thru_replica0` (THRU_R0)."""
    import chip_smoke as cs
    from wittgenstein_tpu.core.node import Node, build_node_columns
    from wittgenstein_tpu.core.registries import (
        registry_network_latencies,
        registry_node_builders,
    )
    from wittgenstein_tpu.core.throughput import MathisNetworkThroughput
    from wittgenstein_tpu.engine import BatchedNetwork, replicate_state
    from wittgenstein_tpu.protocols.pingpong_batched import BatchedPingPong
    from wittgenstein_tpu.utils.javarand import JavaRandom
    from wittgenstein_tpu_torch.interop import state_from_numpy

    class Sized(BatchedPingPong):
        def msg_size(self, mtype: int) -> int:
            return cs.THRU_SIZE

    n = cs.PP_NODES
    nb = registry_node_builders.get_by_name(None)
    latency = registry_network_latencies.get_by_name(None)
    rd = JavaRandom(0)
    cols = build_node_columns([Node(rd, nb) for _ in range(n)])
    proto = Sized(n)
    net = BatchedNetwork(proto, latency, n, capacity=2 * n + 64,
                         msg_discard_time=cs.THRU_DISCARD_MS,
                         throughput=MathisNetworkThroughput(latency, cs.THRU_WINDOW))
    state = net.init_state(cols, seed=0, proto=proto.proto_init(n))
    s = net.run_ms_batched(replicate_state(state, 1), ms, stop_when_done=True)
    leaves = {k: v if isinstance(v, tuple) else np.asarray(v)
              for k, v in s._asdict().items() if k != "proto"}
    leaves["proto"] = {k: np.asarray(v) for k, v in s.proto.items()}
    return {"ms": ms, "replica0": cs.thru_replica0(net, state_from_numpy(leaves, "cpu"))}


def serve(ms: int) -> dict:
    """The JAX package's run_singleton digest of every serve-phase job."""
    del ms
    import chip_smoke as cs
    from wittgenstein_tpu.profiling.ablation import flagship_params
    from wittgenstein_tpu.protocols.handel import HandelParameters
    from wittgenstein_tpu.serve import BatchScheduler, jobs

    handel_params = dict(cs.serve_jobs())["handel_400"]["params"]
    if handel_params != dataclasses.asdict(flagship_params(cs.FLAGSHIP_NODES)):
        raise SystemExit("the serve phase's Handel params are not the JAX package's flagship")

    def handel(params, telemetry):
        # score_cache on, as the port's make_handel has it on the card: the
        # four cache leaves are in every Handel row's digest
        return make_handel(HandelParameters(**params), telemetry=telemetry, score_cache=True)

    jobs.SERVE_PROTOCOLS["Handel"] = dataclasses.replace(
        jobs.serve_protocol("Handel"), build=handel)
    sched = BatchScheduler(auto_start=False)
    out = {}
    for label, spec in cs.serve_jobs():
        t0 = time.perf_counter()
        res = sched.run_singleton(spec)
        out[label] = res["digest"]
        print(json.dumps({"job": label, "digest": res["digest"], "time": res["time"],
                          "seconds": round(time.perf_counter() - t0, 1)}), flush=True)
    return {"serve_r0": out}


def anim(ms: int) -> dict:
    """HandelScenarios.genAnim's run as the JAX package's gen_anim runs it
    (128 nodes under default_params with no dead nodes, run_ms a frame at
    a time), its frames read as the port's anim_frames gives them and
    summarized by chip_smoke's anim_summary (ANIM_R0)."""
    import chip_smoke as cs
    from wittgenstein_tpu.ops.bitops import popcount_words

    net, state = make_handel(default_params(cs.ANIM_NODES, dead_ratio=0.0))
    live = ~np.asarray(state.down)
    ids = np.flatnonzero(live)
    xs, ys = np.asarray(state.x)[live], np.asarray(state.y)[live]
    frames, t = [], 0
    while t < ms:
        state = net.run_ms(state, cs.ANIM_FREQ_MS)
        t += cs.ANIM_FREQ_MS
        held = np.asarray(popcount_words(state.proto["inc"]))[live]
        done = (np.asarray(state.done_at) > 0)[live]
        frames.append((t, {"id": ids, "x": xs, "y": ys, "val": held, "special": done}))
    return {"ms": ms, "replica0": cs.anim_summary(frames)}


READERS = {"anim": anim, "durable": durable, "serve": serve, "throughput": throughput,
           "ethpow": ethpow,
           "p2phandel": p2phandel, "sanfermin": sanfermin, "handeleth2": handeleth2,
           "cappos": cappos}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("what", choices=("byzantine", "cities") + tuple(READERS))
    ap.add_argument("--nodes", type=int, default=4096)
    ap.add_argument("--point", type=int, default=0)
    ap.add_argument("--row", type=int, default=0, help="the row of the group (seed + row)")
    ap.add_argument("--max-ms", type=int, default=3000)
    ap.add_argument("--after", type=float, default=1.6,
                    help="stop at this multiple of row 0's completion depth")
    ap.add_argument("--ms", type=int, default=300)
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    if a.what == "byzantine":
        res = byzantine(a.nodes, a.point, a.row, a.max_ms, a.after)
    elif a.what == "cities":
        res = cities(a.nodes, a.ms)
    else:
        res = READERS[a.what](a.ms)
    with open(a.out, "w") as f:
        json.dump(res, f)
    print(json.dumps({k: v for k, v in res.items() if k != "by_depth"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
