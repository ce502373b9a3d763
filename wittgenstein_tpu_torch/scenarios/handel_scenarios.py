"""HandelScenarios on the port's batched engine (HandelScenarios.java:22).

One command reproduces a scenario battery as CSV + stdout lines in the
reference's `id, nodes, value, BasicStats` shape — each battery a few
stacked batched runs (one per group of configs, scenarios/sweep.py)
instead of sequential reseeded runs:

    python -m wittgenstein_tpu_torch.scenarios.handel_scenarios tor \
        --nodes 128 --replicas 4 --out tor.csv

It runs on the GPU; `--device cpu` runs the plain versions on the CPU.

Scenarios (HandelScenarios.java refs):
  tor             impact of the ratio of nodes behind Tor (:177-190)
  byzantine       byzantineSuicide dead-ratio sweep 0-50% (:204-236)
  hidden          hiddenByzantine dead-ratio sweep (:259-287)
  desync          desynchronized start impact (:192-202 noSyncStart)
  log             node-count scaling sweep + PNG pair (:324-363)
  logErrors       node sweep at a fail-silent ratio + PNGs (:365-431)
  logPeriodTime   dissemination-period sweep + PNGs (:433-473)
  logDelayedStart desynchronizedStart sweep + PNGs (:475-520)
  logStartTime    levelWaitTime sweep + PNGs (:522-563)
  logExtraCycle   extraCycle sweep (:565-586)
  logContactedNode fastPath sweep + PNGs (:588-632)
  window          windowInitial sweep (WindowParameters, Handel.java:150-210)
  genAnim         one Handel run drawn as an animated GIF on the world
                  map (:291, Handel.drawImgs :700-768), one frame every
                  --frequency-ms; drawing needs PIL
  delayedStart    the delayedStartImpact arithmetic (:300-322)
  all             allScenarios battery (:633-656): the four log* sweeps at
                  (dead, tor) in {(0,0), (.2,0), (.2,.2)} with the
                  reference's CSV ids

The reference runs every battery at n=4096 with CITIES placement; the
CLI keeps n a flag (--nodes) so the full-size battery is one command on
the card while the tests use small n.  PNGs use the reference's file
names (handel_log_time.png, handel_period_time.png, ...); drawing them
needs matplotlib.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np

from ..engine import resolve_device
from ..tools.csv_formatter import CSVFormatter
from .sweep import BasicStats, SweepConfig, default_params, run_sweep

CSV_FIELDS = [
    "id",
    "nodes",
    "value",
    "done_at_min",
    "done_at_avg",
    "done_at_max",
    "msg_rcv_min",
    "msg_rcv_avg",
    "msg_rcv_max",
    "msg_filtered_avg",
    "sigs_checked_avg",
]


def tor_configs(nodes: int) -> List[SweepConfig]:
    from ..core.registries import TOR_RATIOS

    return [
        SweepConfig("tor", tor, default_params(nodes, dead_ratio=0.0, tor=tor))
        for tor in TOR_RATIOS
    ]


def byzantine_configs(nodes: int, hidden: bool = False) -> List[SweepConfig]:
    sid = "byzHidden" if hidden else "byzSuicide"
    out = []
    for dr in (0.0, 0.10, 0.20, 0.30, 0.40, 0.50):
        out.append(
            SweepConfig(
                sid,
                dr,
                default_params(
                    nodes,
                    dead_ratio=dr,
                    byzantine_suicide=not hidden and dr > 0,
                    hidden_byzantine=hidden and dr > 0,
                ),
            )
        )
    return out


def desync_configs(nodes: int) -> List[SweepConfig]:
    return [
        SweepConfig(
            "noSyncStart", s, default_params(nodes, dead_ratio=0.0, desynchronized_start=s)
        )
        for s in (0, 50, 100, 200, 400, 800)
    ]


# -- the deep log* battery (HandelScenarios.java:324-632) -------------------
CITIES = "CITIES"


def log_configs(nodes: int, dead: float = 0.0, tor: float = 0.0) -> List[SweepConfig]:
    """log() (:324-363): node-count doubling sweep; expect log time and
    polylog messages.  `nodes` is the sweep CEILING (reference: 8192)."""
    out, n = [], 64
    while n <= max(nodes, 64):
        out.append(
            SweepConfig("log", n, default_params(n, dead_ratio=dead, tor=tor, loc=CITIES))
        )
        n *= 2
    return out


def log_errors_configs(nodes: int, dead: float = 0.0, tor: float = 0.0) -> List[SweepConfig]:
    """logErrors (:365-431): node sweep at a fail-silent dead ratio
    (`dead` = the errorRate argument) with byzantineSuicide signatures and
    a 100 ms desynchronized start."""
    out, n = [], 32
    while n <= max(nodes, 32):
        out.append(
            SweepConfig(
                f"fail-silent:{dead}",
                n,
                default_params(
                    n,
                    dead_ratio=dead,
                    tor=tor,
                    desynchronized_start=100,
                    byzantine_suicide=dead > 0,
                    loc=CITIES,
                ),
            )
        )
        n *= 2
    return out


def log_period_configs(nodes: int, dead: float = 0.0, tor: float = 0.0, sid: str = "period") -> List[SweepConfig]:
    """logPeriodTime (:433-473): dissemination-period sweep at fixed n."""
    return [
        SweepConfig(
            sid,
            pt,
            default_params(
                nodes, dead_ratio=dead, tor=tor, period_time=pt,
                extra_cycle=10, desynchronized_start=100, loc=CITIES,
            ),
        )
        for pt in (1, 5, 10, 15, 20, 40, 80, 160, 320, 640)
    ]


def log_delayed_start_configs(nodes: int, dead: float = 0.0, tor: float = 0.0) -> List[SweepConfig]:
    """logDelayedStart (:475-520): desynchronizedStart sweep."""
    return [
        SweepConfig(
            "delayedStart",
            s,
            default_params(nodes, dead_ratio=dead, tor=tor, desynchronized_start=s, loc=CITIES),
        )
        for s in (0, 10, 20, 30, 50, 70, 100)
    ]


def log_start_time_configs(nodes: int, dead: float = 0.0, tor: float = 0.0, sid: str = "startTime") -> List[SweepConfig]:
    """logStartTime (:522-563): levelWaitTime sweep."""
    return [
        SweepConfig(
            sid,
            s,
            default_params(
                nodes, dead_ratio=dead, tor=tor, desynchronized_start=100,
                level_wait_time=s, loc=CITIES,
            ),
        )
        for s in (0, 25, 50, 75, 100)
    ]


def log_extra_cycle_configs(nodes: int, dead: float = 0.0, tor: float = 0.0, sid: str = "extraCycle") -> List[SweepConfig]:
    """logExtraCycle (:565-586): extraCycle sweep."""
    return [
        SweepConfig(
            sid,
            ec,
            default_params(
                nodes, dead_ratio=dead, tor=tor, extra_cycle=ec,
                desynchronized_start=100, loc=CITIES,
            ),
        )
        for ec in (10, 15, 20, 30, 40, 50)
    ]


def log_contacted_configs(nodes: int, dead: float = 0.0, tor: float = 0.0, sid: str = "fastPath") -> List[SweepConfig]:
    """logContactedNode (:588-632): fastPath peer-count sweep."""
    return [
        SweepConfig(
            sid,
            fp,
            default_params(
                nodes, dead_ratio=dead, tor=tor, desynchronized_start=100,
                fast_path=fp, loc=CITIES,
            ),
        )
        for fp in (0, 5, 10, 20, 40)
    ]


def window_configs(nodes: int, dead: float = 0.0, tor: float = 0.0) -> List[SweepConfig]:
    """Window-parameter exploration (WindowParameters/ScoringExp,
    Handel.java:150-210): the batteries' missing knob — sweep the initial
    window size through the adaptation range."""
    return [
        SweepConfig(
            "window",
            w,
            default_params(nodes, dead_ratio=dead, tor=tor, window_initial=w, loc=CITIES),
        )
        for w in (1, 4, 16, 64, 128)
    ]


def delayed_start_impact(n: int, wait_time: int, period: int) -> tuple:
    """delayedStartImpact (:300-322): pure arithmetic — how many sends the
    levelWaitTime gating saves over the first second."""
    from ..utils.more_math import log2

    m_f = m_s = 0
    for time in range(0, 1001, period):
        for level in range(1, log2(n) + 1):
            m_f += 1
            if time >= (level - 1) * wait_time:
                m_s += 1
    saved = m_f - m_s
    print(
        f"Sent w/o waitTime: {m_f}, w/ waitTime:{m_s}, "
        f"saved= {saved} - {saved / m_s}"
    )
    return m_f, m_s


SCENARIOS = {
    "tor": tor_configs,
    "byzantine": byzantine_configs,
    "hidden": lambda n, **kw: byzantine_configs(n, hidden=True),
    "desync": desync_configs,
    "log": log_configs,
    "logErrors": log_errors_configs,
    "logPeriodTime": log_period_configs,
    "logDelayedStart": log_delayed_start_configs,
    "logStartTime": log_start_time_configs,
    "logExtraCycle": log_extra_cycle_configs,
    "logContactedNode": log_contacted_configs,
    "window": window_configs,
}

# which batteries take (dead, tor) CLI knobs
_DEAD_TOR = {
    "log", "logErrors", "logPeriodTime", "logDelayedStart",
    "logStartTime", "logExtraCycle", "logContactedNode", "window",
}

# battery -> (png stem, x-axis label) for the reference's graph pairs
_GRAPHS = {
    "log": ("handel_log", "number of nodes"),
    "logErrors": ("handel_log_errors", "number of nodes"),
    "logPeriodTime": ("handel_period", "period time in ms"),
    "logDelayedStart": ("handel_delayedStart", "delay in ms"),
    "logStartTime": ("handel_startTime", "start time in ms"),
    "logContactedNode": ("handel_fastpath", "fast path peer count"),
}


def save_battery_graphs(name: str, configs: List[SweepConfig], stats: List[BasicStats], out_dir: str = ".") -> List[str]:
    """The reference's PNG pair per battery: avg time vs the swept value,
    avg messages vs the swept value (Graph usage, e.g. :345-363)."""
    import os

    from ..tools.graph import Graph, ReportLine, Series

    if name not in _GRAPHS:
        return []
    stem, x_name = _GRAPHS[name]
    t_a = Series("average time")
    m_a = Series("average number of messages")
    for c, bs in zip(configs, stats):
        t_a.add_line(ReportLine(float(c.value), bs.done_at_avg))
        m_a.add_line(ReportLine(float(c.value), bs.msg_rcv_avg))
    paths = []
    g = Graph(f"time vs. {x_name}", x_name, "time in milliseconds")
    g.add_serie(t_a)
    p = os.path.join(out_dir, f"{stem}_time.png")
    g.save(p)
    paths.append(p)
    g = Graph(f"messages vs. {x_name}", x_name, "number of messages")
    g.add_serie(m_a)
    p = os.path.join(out_dir, f"{stem}_msg.png")
    g.save(p)
    paths.append(p)
    return paths


# allScenarios (:633-656): the four parameter sweeps at three (dead, tor)
# corners, with the reference's CSV id per block.  Note the period ids are
# the reference's own quirk — "301" tags the CLEAN corner and "30" the
# dead corner (:638-639), inverted vs the other sweeps' base/base+1
# pattern; kept verbatim so CSVs line up with the reference's output.
ALL_BATTERY = [
    (log_period_configs, 0.0, 0.0, "301"),
    (log_period_configs, 0.2, 0.0, "30"),
    (log_extra_cycle_configs, 0.0, 0.0, "40"),
    (log_extra_cycle_configs, 0.2, 0.0, "401"),
    (log_start_time_configs, 0.0, 0.0, "10"),
    (log_start_time_configs, 0.2, 0.0, "101"),
    (log_contacted_configs, 0.0, 0.0, "20"),
    (log_contacted_configs, 0.2, 0.0, "201"),
    (log_extra_cycle_configs, 0.2, 0.2, "41"),
    (log_start_time_configs, 0.2, 0.2, "111"),
    (log_contacted_configs, 0.2, 0.2, "211"),
    (log_period_configs, 0.2, 0.2, "311"),
]


def run_all(nodes: int, replicas: int, sim_ms: int, out: Optional[str], battery=None,
            device=None) -> None:
    """allScenarios: every sweep in ALL_BATTERY, one combined CSV."""
    csv = CSVFormatter("allScenarios", CSV_FIELDS)
    print("type, node, analyzed, msg, msgFiltered, sigsChecked, time")
    for fn, dead, tor, sid in battery or ALL_BATTERY:
        configs = fn(nodes, dead=dead, tor=tor, sid=sid)
        stats = run_sweep(configs, replicas=replicas, sim_ms=sim_ms, device=device)
        for c, bs in zip(configs, stats):
            print(
                f"{sid}, {nodes}, {c.value}, {bs.msg_rcv_avg}, "
                f"{bs.msg_filtered_avg}, {bs.sigs_checked_avg}, {bs.done_at_avg}"
            )
            csv.add({"id": sid, "nodes": nodes, "value": c.value, **bs.row()})
    if out:
        csv.save(out)
        print(f"wrote {out}")


def anim_frames(nodes: int = 128, sim_ms: int = 3000, frequency_ms: int = 10, device=None):
    """The run behind HandelScenarios.genAnim (:291): Handel at `nodes`
    under default_params with no dead nodes, one replica, advanced
    `frequency_ms` at a time up to `sim_ms`; yields each frame as
    (t, rows) with rows a dict of [live] numpy arrays — `id`, `x`, `y`,
    `val` (signatures held: the popcount of the node's aggregate) and
    `special` (done).  The network is built here, on the device (CUDA
    unless asked for the CPU), and the run advances as the frames are
    taken; the frames are host arrays, so drawing them needs no device."""
    from ..engine import map_state
    from ..ops.bitops import popcount_words
    from ..protocols.handel_batched import make_handel

    net, state = make_handel(default_params(nodes, dead_ratio=0.0),
                             device=resolve_device(device))
    live = ~state.down.cpu().numpy()
    ids = np.flatnonzero(live).astype(np.int32)
    xs, ys = state.x.cpu().numpy()[live], state.y.cpu().numpy()[live]

    def frames(states):
        t = 0
        while t < sim_ms:
            states = net.run_ms_batched(states, frequency_ms)
            t += frequency_ms
            held = popcount_words(states.proto["inc"][0]).cpu().numpy()
            done = states.done_at[0].cpu().numpy() > 0
            yield t, {"id": ids, "x": xs, "y": ys, "val": held[live], "special": done[live]}

    return frames(map_state(lambda a: a.unsqueeze(0), state))  # one replica, its own seed


def gen_anim(
    nodes: int = 128,
    sim_ms: int = 3000,
    frequency_ms: int = 10,
    dest: str = "handel.gif",
    device=None,  # None = CUDA; "cpu" runs the plain versions
) -> str:
    """HandelScenarios.genAnim (:291) via Handel.drawImgs (:700-768): the
    run of anim_frames rendered as a GIF — each node a map dot colored by
    its aggregate signature count (red->green ramp), done nodes marked.
    Drawing needs PIL."""
    from types import SimpleNamespace

    from ..tools.node_drawer import NodeDrawer, NodeStatus

    class HStatus(NodeStatus):
        # Handel's HNodeStatus: value = signatures held, special = done
        def get_val(self, n):
            return n.val

        def is_special(self, n):
            return n.special

        def get_max(self):
            return nodes

        def get_min(self):
            return 0

    frames = anim_frames(nodes, sim_ms, frequency_ms, device=device)
    with NodeDrawer(HStatus(), dest, frequency_ms) as drawer:
        for t, rows in frames:
            live = [
                SimpleNamespace(node_id=int(i), x=int(x), y=int(y), val=int(v), special=bool(s))
                for i, x, y, v, s in zip(rows["id"], rows["x"], rows["y"], rows["val"],
                                         rows["special"])
            ]
            drawer.draw_new_state(t, live)
    return dest


def run_scenario(
    name: str,
    nodes: int = 128,
    replicas: int = 4,
    sim_ms: int = 4000,
    out: Optional[str] = None,
    dead: float = 0.0,
    tor: float = 0.0,
    graphs_dir: Optional[str] = None,
    device=None,  # None = CUDA; "cpu" runs the plain versions
) -> List[BasicStats]:
    kw = {"dead": dead, "tor": tor} if name in _DEAD_TOR else {}
    configs = SCENARIOS[name](nodes, **kw)
    stats = run_sweep(configs, replicas=replicas, sim_ms=sim_ms, device=device)
    csv = CSVFormatter(name, CSV_FIELDS)
    for c, bs in zip(configs, stats):
        n_cfg = c.params.node_count
        print(f"{c.label}, {n_cfg}, {c.value}, {bs}")
        csv.add({"id": c.label, "nodes": n_cfg, "value": c.value, **bs.row()})
    if out:
        csv.save(out)
        print(f"wrote {out}")
    if graphs_dir is not None:
        for p in save_battery_graphs(name, configs, stats, graphs_dir):
            print(f"wrote {p}")
    return stats


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("scenario", choices=sorted(SCENARIOS) + ["genAnim", "delayedStart", "all"])
    ap.add_argument("--nodes", type=int, default=128)
    ap.add_argument("--replicas", type=int, default=4)
    ap.add_argument("--sim-ms", type=int, default=4000)
    ap.add_argument("--out", default=None)
    ap.add_argument("--frequency-ms", type=int, default=10)
    ap.add_argument("--dead", type=float, default=0.0)
    from ..core.registries import TOR_RATIOS

    ap.add_argument(
        "--tor", type=float, default=0.0, choices=TOR_RATIOS,
        help="fraction of nodes behind Tor (registry-backed ratios only)",
    )
    ap.add_argument("--graphs-dir", default=None,
                    help="write the reference's PNG pair for this battery here")
    ap.add_argument("--wait-time", type=int, default=50)
    ap.add_argument("--period", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a GPU) or cpu")
    a = ap.parse_args(argv)
    if a.scenario == "genAnim":
        dest = gen_anim(a.nodes, a.sim_ms, a.frequency_ms, a.out or "handel.gif",
                        device=a.device)
        print(f"wrote {dest}")
        return
    if a.scenario == "delayedStart":
        delayed_start_impact(a.nodes, a.wait_time, a.period)
        return
    if a.scenario == "all":
        run_all(a.nodes, a.replicas, a.sim_ms, a.out, device=a.device)
        return
    run_scenario(
        a.scenario, a.nodes, a.replicas, a.sim_ms, a.out,
        dead=a.dead, tor=a.tor, graphs_dir=a.graphs_dir, device=a.device,
    )


if __name__ == "__main__":
    main()
