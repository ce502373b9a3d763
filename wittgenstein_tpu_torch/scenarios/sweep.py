"""The batched sweep runner: stacked configurations x replicas in one
`run_ms_batched` call per group.

Port of the JAX package's scenarios/sweep.py, the replacement for
HandelScenarios.run (HandelScenarios.java:140-160): where the reference
runs `rounds` sequential reseeded simulations per configuration and
averages StatsHelper outputs, every (config, replica) pair is one row of
a stacked state and a whole group runs in lockstep.  Configs sharing
every traced parameter (all but `_STATE_ONLY_FIELDS`) form one group and
run on the group's first config's engine; statistics reduce on the host
over the live nodes of each config's rows.  Every entry point runs on
CUDA unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import stats as SH
from ..engine import map_state, replicate_state, resolve_device, stack_states
from ..faults import FaultConfig, fault_state_digest, neutral_fault_state, stack_fault_states
from ..protocols.handel import HandelParameters
from ..protocols.handel_batched import make_handel


def _host(a) -> np.ndarray:
    return a.cpu().numpy()


@dataclasses.dataclass
class BasicStats:
    """The reference's per-configuration summary (HandelScenarios.java:60-90):
    doneAt and msgReceived min/avg/max over live nodes, plus the
    msgFiltered and sigsChecked averages."""

    done_at_min: int
    done_at_avg: int
    done_at_max: int
    msg_rcv_min: int
    msg_rcv_avg: int
    msg_rcv_max: int
    msg_filtered_avg: int
    sigs_checked_avg: int

    def __str__(self) -> str:
        return (
            f"doneAtAvg={self.done_at_avg}, doneAtMin={self.done_at_min}"
            f", doneAtMax={self.done_at_max}, msgRcvAvg={self.msg_rcv_avg}"
            f", msgFilteredAvg={self.msg_filtered_avg}"
            f", sigsCheckedAvg={self.sigs_checked_avg}"
        )

    def row(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class SweepConfig:
    """One sweep point: a Handel configuration plus its sweep label."""

    label: str
    value: object  # the swept variable's value (tor %, byz fraction, ...)
    params: HandelParameters


# Parameter fields that live in the per-row STATE (down set, start times,
# node positions and speeds) rather than the engine; only these may differ
# between configs sharing one group.  Every other field splits the group.
_STATE_ONLY_FIELDS = frozenset(
    {"nodes_down", "bad_nodes", "desynchronized_start", "node_builder_name"}
)


def _group_key(p: HandelParameters):
    return tuple(
        (f.name, getattr(p, f.name))
        for f in dataclasses.fields(p)
        if f.name not in _STATE_ONLY_FIELDS
    )


def _host_done_cdf(done_cols: np.ndarray, sim_ms: int, every: int) -> dict:
    """Done-node counts at each window end, computed on the host from the
    final done_at columns ([R, N]): the post-hoc time-to-aggregation CDF."""
    qts = list(range(every - 1, sim_ms, every))
    counts = [
        [int(((dc > 0) & (dc <= t)).sum()) for t in qts] for dc in done_cols
    ]
    return {"times": qts, "counts": counts}


def run_sweep(
    configs: List[SweepConfig],
    replicas: int = 4,
    sim_ms: int = 3000,
    seed0: int = 0,
    stop_when_done: bool = False,
    telemetry=None,
    telemetry_out: Optional[list] = None,
    device=None,  # None = CUDA; "cpu" runs the plain versions
) -> List[BasicStats]:
    """Run every (config x replica) in stacked batches; one BasicStats per
    config, reduced over live nodes of all its replicas.  Row r of config
    i runs seed `seed0 + 1000 * i + r`.

    stop_when_done stops a group once every one of its rows has
    aggregated: doneAt stats are unchanged, but the msgRcv/msgFiltered
    counters stop at the group's completion.

    telemetry takes a telemetry.TelemetryConfig: the sweep then runs
    instrumented (the same simulation state, counter side-car on the
    device) and, when `telemetry_out` is a list, appends one record per
    config: StatsGetter-shaped doneAt/msgReceived reductions, traffic
    counters, the per-replica progress series decoded from the snapshot
    ring, and the host-side done-at CDF from the final state."""
    from ..telemetry import progress_series

    dev = resolve_device(device)
    results: Dict[int, BasicStats] = {}
    tele_records: Dict[int, dict] = {}

    groups: Dict[tuple, List[int]] = {}
    for i, c in enumerate(configs):
        groups.setdefault(_group_key(c.params), []).append(i)

    for idxs in groups.values():
        states, net = [], None
        for i in idxs:
            # the group's first config's engine runs every row of the group
            group_net, st = make_handel(configs[i].params, telemetry=telemetry, device=dev)
            net = net or group_net
            for r in range(replicas):
                states.append(st._replace(seed=torch.full_like(st.seed, seed0 + 1000 * i + r)))
        out = net.run_ms_batched(stack_states(states), sim_ms, stop_when_done)

        down = _host(out.down)
        done = _host(out.done_at)
        rcv = _host(out.msg_received)
        filt = _host(out.proto["msg_filtered"])
        checked = _host(out.proto["sigs_checked"])
        for gpos, i in enumerate(idxs):
            sl = slice(gpos * replicas, (gpos + 1) * replicas)
            live = ~down[sl]
            d = done[sl][live]
            r = rcv[sl][live]
            results[i] = BasicStats(
                int(d.min()),
                int(d.mean()),
                int(d.max()),
                int(r.min()),
                int(r.mean()),
                int(r.max()),
                int(filt[sl][live].mean()),
                int(checked[sl][live].mean()),
            )
            if telemetry is not None and telemetry_out is not None:
                sub = map_state(lambda a: a[sl], out)
                fields = ("min", "max", "avg")

                def cnt(f):
                    return SH.TelemetryCounterStatGetter(f).get(sub).get("count")

                tele_records[i] = {
                    "label": configs[i].label,
                    "value": configs[i].value,
                    "doneAt": {
                        f: SH.DoneAtBatchedStatGetter().get(sub).get(f) for f in fields
                    },
                    "msgReceived": {
                        f: SH.MsgReceivedBatchedStatGetter().get(sub).get(f) for f in fields
                    },
                    "msgSentTotal": cnt("lat_sent"),
                    "msgFilteredTotal": cnt("lat_filtered"),
                    "storeDropped": cnt("dropped"),
                    "ticks": cnt("ticks"),
                    "progress": progress_series(sub),
                    "doneAtCdfHost": _host_done_cdf(
                        done[sl], sim_ms, telemetry.snapshot_every_ms
                    ),
                }

    if telemetry is not None and telemetry_out is not None:
        telemetry_out.extend(tele_records[i] for i in range(len(configs)))
    return [results[i] for i in range(len(configs))]


# Dedupe accounting for run_fault_sweep: identical plans in one population
# run once and their records fan back out; these counters observe that.
SWEEP_COUNTERS = {
    "plans_in": 0,
    "plans_evaluated": 0,
    "plans_deduped": 0,
}


def sweep_counters() -> Dict[str, int]:
    return dict(SWEEP_COUNTERS)


def run_fault_sweep(
    net,
    state,
    plans: list,
    sim_ms: int,
    replicas_per_plan: int = 1,
    faults=None,
    seed0: int = 0,
    stop_when_done: bool = False,
    done_cdf_every: int = 0,
    checkpoint_dir: Optional[str] = None,
    chunk_ms: Optional[int] = None,
    supervisor_kw: Optional[dict] = None,
    use_run_cache: bool = False,
):
    """The fault-axis sweep: one `run_ms_batched` call where replica row
    `r` runs fault plan `plans[r // replicas_per_plan]` (None entries =
    fault-free control rows), on the device of the built (net, state).
    Returns (out, records): the final stacked state plus one record per
    plan with availability (done fraction of statically-live nodes),
    done-at quantiles over done nodes, and the per-plan fault counters.

    Identical plans are deduped by lowered-plan digest: each distinct
    schedule runs once (its `replicas_per_plan` rows, seeded at its first
    occurrence's position) and its record fans back out to every
    duplicate, so `out` stacks `n_unique * replicas_per_plan` rows; each
    record carries its `plan_digest` and the `seed0_row` its first row
    ran with.

    checkpoint_dir makes the sweep resumable: the pass runs chunked
    (chunk_ms, default min(sim_ms, 100)) under runtime.Supervisor with a
    checkpoint a chunk; an interrupted sweep re-invoked with the same
    arguments resumes at its last checkpoint and gives a report equal to
    the uninterrupted sweep's (keep stop_when_done=False for that claim:
    the early exit depends on the chunk boundaries).  supervisor_kw goes
    to `Supervisor.from_network` (recorder, timeseries, sentinel,
    heartbeat, budget_s, max_chunks_this_run, ...).  A controlled partial
    stop (budget or chunk cap) raises RunIncompleteError carrying the
    partial RunReport.  The checkpoints are the JAX package's files, so a
    sweep checkpointed by either package resumes in the other.

    use_run_cache (the JAX package's cached compiled-program path) is
    not ported: it raises."""
    if use_run_cache and stop_when_done:
        raise ValueError(
            "use_run_cache evaluates a fixed-horizon cached program; "
            "stop_when_done is not supported on that path"
        )
    if use_run_cache and checkpoint_dir is not None:
        raise ValueError(
            "use_run_cache and checkpoint_dir are mutually exclusive "
            "(the resumable path runs chunked under the Supervisor)"
        )
    if use_run_cache:
        raise NotImplementedError(
            "use_run_cache needs parallel.replica_shard, which is not ported "
            "(ROADMAP Queue A 16)"
        )
    if not plans:
        raise ValueError("run_fault_sweep needs at least one plan")
    rpp = int(replicas_per_plan)
    if rpp < 1:
        raise ValueError(f"replicas_per_plan={rpp} must be >= 1")
    fnet, fstate = net.with_faults(state, faults or FaultConfig())
    n_nodes, n_mt = net.n_nodes, net.protocol.n_msg_types()
    lowered = [
        neutral_fault_state(n_nodes, n_mt, net.device)
        if p is None
        else p.lower(n_nodes, n_mt, net.device)
        for p in plans
    ]
    digests = [fault_state_digest(low) for low in lowered]
    # dedupe by digest, first occurrence wins (rows and seeds are those of
    # the sweep without dedupe whenever all plans are distinct)
    unique_pos: Dict[str, int] = {}
    fan: List[int] = []
    for dig in digests:
        if dig not in unique_pos:
            unique_pos[dig] = len(unique_pos)
        fan.append(unique_pos[dig])
    n_unique = len(unique_pos)
    SWEEP_COUNTERS["plans_in"] += len(plans)
    SWEEP_COUNTERS["plans_evaluated"] += n_unique
    SWEEP_COUNTERS["plans_deduped"] += len(plans) - n_unique
    first_of = {u: i for i, u in reversed(list(enumerate(fan)))}
    n_rep = n_unique * rpp
    fs = stack_fault_states(
        [lowered[first_of[u]] for u in range(n_unique) for _ in range(rpp)]
    )
    batched = replicate_state(
        fstate, n_rep, seeds=np.arange(seed0, seed0 + n_rep, dtype=np.int64)
    )._replace(faults=fs)
    if checkpoint_dir is not None:
        from ..runtime import RunIncompleteError, Supervisor

        cms = int(chunk_ms or min(sim_ms, 100))
        if sim_ms % cms != 0:
            raise ValueError(
                f"chunk_ms={cms} must divide sim_ms={sim_ms} for a "
                "resumable sweep"
            )
        sup = Supervisor.from_network(
            fnet,
            batched,
            total_ms=sim_ms,
            chunk_ms=cms,
            stop_when_done=stop_when_done,
            checkpoint_dir=checkpoint_dir,
            **(supervisor_kw or {}),
        )
        report = sup.run()
        if not report.ok:
            raise RunIncompleteError(
                f"fault sweep stopped after {report.chunks_done}/"
                f"{sup.n_chunks} chunks (budget/cap reached); checkpoint "
                "saved — re-invoke with the same arguments to resume",
                report=report,
            )
        out = report.state
    else:
        out = fnet.run_ms_batched(batched, sim_ms, stop_when_done)

    done = _host(out.done_at)
    down = _host(out.down)
    dropped = _host(out.faults.dropped_by_fault)
    delayed = _host(out.faults.delayed_by_fault)
    records = []
    for i, plan in enumerate(plans):
        u = fan[i]
        sl = slice(u * rpp, (u + 1) * rpp)
        live = ~down[sl]
        d = done[sl][live]
        fin = d[d > 0]
        rec = {
            "plan": (
                {"label": "control"} if plan is None else plan.describe()
            ),
            "plan_digest": digests[i],
            "seed0_row": int(seed0 + u * rpp),
            "replicas": rpp,
            "live_nodes": int(live.sum()),
            "done_nodes": int(fin.size),
            "availability": round(float(fin.size) / max(1, live.sum()), 4),
            "done_at_ms": (
                {
                    "p10": int(np.percentile(fin, 10)),
                    "p50": int(np.percentile(fin, 50)),
                    "p90": int(np.percentile(fin, 90)),
                    "max": int(fin.max()),
                }
                if fin.size
                else None
            ),
            "dropped_by_fault": dropped[sl].sum(axis=0).tolist(),
            "delayed_by_fault": delayed[sl].sum(axis=0).tolist(),
        }
        if done_cdf_every:
            rec["done_cdf"] = _host_done_cdf(done[sl], sim_ms, done_cdf_every)
        records.append(rec)
    return out, records


def default_params(
    nodes: int,
    dead_ratio: Optional[float] = None,
    tor: Optional[float] = None,
    period_time: Optional[int] = None,
    extra_cycle: Optional[int] = None,
    desynchronized_start: Optional[int] = None,
    byzantine_suicide: bool = False,
    hidden_byzantine: bool = False,
    loc: Optional[str] = None,
    level_wait_time: Optional[int] = None,
    fast_path: Optional[int] = None,
    window_initial: Optional[int] = None,
) -> HandelParameters:
    """HandelScenarios.defaultParams (HandelScenarios.java:65-122), full
    signature.  loc=None keeps the JAX package's battery's RANDOM
    placement with the default latency; "AWS"/"CITIES"/"RANDOM" mirror
    the reference's Location -> (builder, latency) mapping (:84-90)."""
    from ..core.registries import AWS, CITIES, RANDOM, builder_name

    dead_ratio = 0.10 if dead_ratio is None else dead_ratio
    dead = int(nodes * dead_ratio)
    threshold = int(nodes * (1.0 - dead_ratio) * 0.99)
    threshold = max(2, min(threshold, nodes - dead))
    if loc is None:
        nb_name = builder_name(RANDOM, True, tor or 0.0)
        lat_name = None
    else:
        # the reference builds RegistryNodeBuilders.name(loc, false, tor)
        nb_name = builder_name(loc, False, tor or 0.0)
        lat_name = {
            AWS: "AwsRegionNetworkLatency",
            CITIES: "NetworkLatencyByCityWJitter",
            RANDOM: "NetworkLatencyByDistanceWJitter",
        }[loc]
    kw = {} if window_initial is None else {"window_initial": window_initial}
    return HandelParameters(
        node_count=nodes,
        threshold=threshold,
        pairing_time=4,
        level_wait_time=50 if level_wait_time is None else level_wait_time,
        extra_cycle=10 if extra_cycle is None else extra_cycle,
        dissemination_period_ms=20 if period_time is None else period_time,
        fast_path=10 if fast_path is None else fast_path,
        nodes_down=dead,
        node_builder_name=nb_name,
        network_latency_name=lat_name,
        desynchronized_start=desynchronized_start or 0,
        byzantine_suicide=byzantine_suicide,
        hidden_byzantine=hidden_byzantine,
        **kw,
    )
