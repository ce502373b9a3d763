"""Batched time-stepped simulation core, the main-path subset.

Re-expression of the reference DES (core Network.java) as a synchronous
per-millisecond state transition, ported from the JAX package's
engine/core.py:

  * node state is a struct-of-arrays of `[R, N]` columns — the replica
    axis R is carried explicitly in every tensor, where the JAX package
    writes one replica and `vmap`s it;
  * per-destination latency jitter comes from the reference's own xorshift
    counter hash (rng.pseudo_delta), so multicast costs no per-dest state;
  * in-flight messages live in a TIME WHEEL — `[W, B]` buckets keyed by
    `arrival mod W` plus a small `[V]` overflow lane for beyond-horizon
    arrivals and full-row spill; `wheel_rows=0` selects the flat store,
    where every message goes through the overflow lane (the old full-scan
    ring);
  * one tick delivers every due message, runs the protocol's vectorized
    hooks and appends emissions; the loop is a host loop whose clock `t`
    is a Python int.  Per-ms ticking protocols (TICK_INTERVAL 1) run in
    lockstep.  A batch whose replicas' clocks differ is split once into
    groups of one clock each (`_clock_groups`, one device read); every
    group steps at its own clock on each loop index, and the groups are
    merged at the end, as the JAX package's vmapped loops give each
    replica its own clock.  Event-driven protocols (TICK_INTERVAL None)
    run the JAX package's consensus-jump loop: each iteration executes
    the one tick that is the minimum clock over the replicas still
    running, and each replica then jumps to its own next arrival.

A `FaultConfig` arms the fault side-car (`with_faults`, faults/): its
lanes act at the send path (`_send_rows`) and the delivery view; with
`faults=None` the engine runs no fault op and the state carries
`faults=()`.  A `TelemetryConfig` arms the telemetry side-car
(`with_telemetry`, telemetry/): counters at the send path, the store
insert and the delivery view, the loop census and the snapshot ring on
every executed tick; with `telemetry=None` the engine runs no telemetry
op and the state carries `tele=()`.  The port runs no other tick
interval; it raises on those.  Its one step is the JAX package's fused
step (`fuse_step=True`), with the unfused step's exact row clear (see
`_clear_visited_rows`).

Every function is functional: it never writes into a tensor it was given,
so a caller's state stays valid after a run, as with JAX.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..core.latency import LatencyStatic, NetworkLatency, vec_latency
from ..faults.state import (
    FaultConfig,
    FaultState,
    deliver_suppress,
    inflate_latency,
    neutral_fault_state,
    send_suppress,
)
from ..ops.bitops import lowest_set_bit, pack_occupied, popcount_words
from ..ops.indexing import add_at, add_masked, set_rows, take
from ..telemetry.state import (
    TelemetryConfig,
    TelemetryState,
    count_by_type,
    init_telemetry,
    record_snapshot,
)
from .density import lane_plan
from .rng import hash32, pseudo_delta

MAX_PARTITIONS = 4
INT_MAX = 2**31 - 1

# default wheel horizon, ms, as in the JAX package: longer delays spill to
# the overflow lane, which stays exact
DEFAULT_WHEEL_ROWS = 512


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Without a card, the CUDA default raises; it never falls back
    to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain versions on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


class SimState(NamedTuple):
    """Simulation state; every field is a tensor (or the empty side-car
    tuple) with the same name, shape and dtype as the JAX package's
    SimState leaf — uint32 words there are int32 bit views here.  A
    single replica's state has no leading axis; a batched one has [R]."""

    time: torch.Tensor  # int32, ms (Network.java:46-49)
    seed: torch.Tensor  # int32, per-replica base seed
    send_ctr: torch.Tensor  # int32: per-send-event counter (seeds)
    # node columns (Node.java:22-88)
    down: torch.Tensor  # bool[N]
    done_at: torch.Tensor  # int32[N]
    msg_received: torch.Tensor  # int32[N]
    msg_sent: torch.Tensor  # int32[N]
    bytes_received: torch.Tensor  # int32[N]
    bytes_sent: torch.Tensor  # int32[N]
    # latency inputs
    x: torch.Tensor  # int32[N]
    y: torch.Tensor  # int32[N]
    extra_latency: torch.Tensor  # int32[N]
    city_idx: torch.Tensor  # int32[N]
    # partitions (Network.java:639-707)
    partition_x: torch.Tensor  # int32[MAX_PARTITIONS], INT_MAX = unused
    # time wheel [W, B]: row r holds messages with eff-arrival = r (mod W);
    # degenerate 1x1 in flat mode, never occupied
    msg_valid: torch.Tensor  # bool[W, B]
    msg_arrival: torch.Tensor  # int32[W, B]
    msg_from: torch.Tensor  # lanes.idx[W, B]
    msg_to: torch.Tensor  # lanes.idx[W, B]
    msg_type: torch.Tensor  # lanes.mtype[W, B]
    msg_payload: torch.Tensor  # int32[W, B, P]
    whl_fill: torch.Tensor  # int32[W]: valid entries per row (dense prefix)
    # overflow lane [V]: beyond-horizon arrivals and full-row spill; in
    # flat mode, the whole message store
    ovf_valid: torch.Tensor  # bool[V]
    ovf_arrival: torch.Tensor  # int32[V]
    ovf_from: torch.Tensor  # lanes.idx[V]
    ovf_to: torch.Tensor  # lanes.idx[V]
    ovf_type: torch.Tensor  # lanes.mtype[V]
    ovf_payload: torch.Tensor  # int32[V, P]
    msg_head: torch.Tensor  # int32: monotone sent-message counter
    dropped: torch.Tensor  # int32: store overflow count
    proto: Any  # protocol-defined dict of tensors
    tele: Any = ()  # telemetry side-car: () or a telemetry.TelemetryState
    faults: Any = ()  # fault side-car: () or a faults.FaultState


def map_state(fn, *states: SimState) -> SimState:
    """Apply fn leaf-wise over SimStates of the same structure (proto dict
    and side-car leaves included; empty side-cars pass through)."""
    out = {}
    for f in SimState._fields:
        vals = [getattr(s, f) for s in states]
        if isinstance(vals[0], dict):
            out[f] = {k: fn(*[v[k] for v in vals]) for k in vals[0]}
        elif isinstance(vals[0], (FaultState, TelemetryState)):
            out[f] = type(vals[0])(*[fn(*xs) for xs in zip(*vals)])
        elif isinstance(vals[0], torch.Tensor):
            out[f] = fn(*vals)
        else:
            out[f] = vals[0]
    return SimState(**out)


def _lane_select(alive: torch.Tensor, new: SimState, old: SimState) -> SimState:
    """Per-replica select: lanes where `alive` take `new`, others keep `old`."""
    def sel(a, b):
        return torch.where(alive.view((-1,) + (1,) * (a.dim() - 1)), a, b)

    return map_state(sel, new, old)


@dataclasses.dataclass
class Emission:
    """A batched send request: K candidate messages per replica (the analog
    of one Network.send call, Network.java:341-447).

    mask[R, K] selects real sends; from_idx/to_idx are [R, K] (or [K],
    shared by every replica) node ids; payload is [R, K, P] (or None when
    P=0).  mtype is a static int or a per-row [R, K] tensor; send_time an
    int or a tensor that broadcasts to [R, K] ([K] shared by every
    replica, [R, 1] per replica).  arrival, when given, bypasses the
    latency model and sender counters (sendArriveAt,
    Network.java:419-422)."""

    mask: torch.Tensor
    from_idx: torch.Tensor
    to_idx: torch.Tensor
    mtype: "int | torch.Tensor"
    payload: Optional[torch.Tensor] = None
    send_time: "int | torch.Tensor | None" = None  # default: t + 1
    arrival: Optional[torch.Tensor] = None  # explicit arrival times [R, K]

    @classmethod
    def no_rows(cls, r: int, mtype: int, payload_width: int, device) -> "Emission":
        """An emission with no rows for R replicas: it changes no state but
        takes its send counter, as one whose every row is masked does."""
        ids = torch.zeros(0, dtype=torch.int32, device=device)
        return cls(mask=torch.zeros((r, 0), dtype=torch.bool, device=device), from_idx=ids,
                   to_idx=ids, mtype=mtype,
                   payload=torch.zeros((r, 0, payload_width), dtype=torch.int32, device=device))


class BatchedNetwork:
    """The engine: binds a latency model and a protocol to the step and
    run functions.  One instance serves any replica count (everything
    batched lives in SimState).

    Message storage is a time wheel `[wheel_rows, wheel_slots]` plus an
    `[overflow_capacity]` lane; `wheel_rows=0` selects the flat store.
    `capacity` is the total in-flight budget and sizes the wheel and
    overflow defaults, as in the JAX package.  `batched_jumps` is
    accepted for the JAX package's signature: an event-driven protocol
    always runs the consensus-jump loop here, which the JAX package pins
    bit-identical to its default loop."""

    def __init__(
        self,
        protocol,
        latency: NetworkLatency,
        n_nodes: int,
        capacity: int = 1 << 14,
        wheel_rows: Optional[int] = None,
        wheel_slots: Optional[int] = None,
        overflow_capacity: Optional[int] = None,
        telemetry=None,
        faults=None,
        batched_jumps: bool = False,
        device=None,
    ):
        if telemetry is not None and not isinstance(telemetry, TelemetryConfig):
            raise TypeError(f"telemetry must be a TelemetryConfig or None, got {type(telemetry)}")
        if faults is not None and not isinstance(faults, FaultConfig):
            raise TypeError(f"faults must be a FaultConfig or None, got {type(faults)}")
        if protocol.TICK_INTERVAL not in (1, None):
            raise NotImplementedError(
                "the port runs per-ms (TICK_INTERVAL 1) and event-driven "
                "(TICK_INTERVAL None) protocols only"
            )
        self.device = resolve_device(device)
        self.protocol = protocol
        self.latency = latency
        self.n_nodes = n_nodes
        self.capacity = capacity
        self.jump_stats = None  # set by each event-driven run
        # the telemetry side-car's static switch: None runs no telemetry op
        self.telemetry = telemetry
        # the fault lanes' static switch: None runs no fault op
        self.faults = faults
        self.payload_width = protocol.PAYLOAD_WIDTH
        sizes = [protocol.msg_size(t) for t in range(protocol.n_msg_types())]
        self._msg_sizes_host = np.asarray(sizes, dtype=np.int32)
        self._msg_sizes = torch.tensor(sizes, dtype=torch.int32, device=self.device)
        self.lanes = lane_plan(n_nodes, protocol.n_msg_types())
        if wheel_rows is None:
            wheel_rows = DEFAULT_WHEEL_ROWS
        self.flat = wheel_rows == 0
        if self.flat:
            # a degenerate 1x1 wheel keeps the state's shape the JAX
            # package's; inserts never target it
            self.wheel_rows = 1
            self.wheel_slots = 1
            self.overflow_capacity = capacity if overflow_capacity is None else overflow_capacity
        else:
            if wheel_rows % 32:
                raise ValueError(
                    f"wheel_rows={wheel_rows} must be a multiple of 32 "
                    "(occupancy is scanned as packed 32-bit words)"
                )
            self.wheel_rows = wheel_rows
            self.wheel_slots = (
                max(64, -(-2 * capacity // wheel_rows)) if wheel_slots is None else wheel_slots
            )
            # capped: the lane is scanned every tick, so its size must not
            # scale with the total capacity
            self.overflow_capacity = (
                max(128, min(1024, capacity // 8))
                if overflow_capacity is None
                else overflow_capacity
            )
        self._window()  # a quantum wider than the wheel fails here

    # -- state construction (host-side) -------------------------------------
    def init_state(self, cols: dict, seed: int, proto: Any, down=None) -> SimState:
        """A fresh single-replica state from node columns
        (core.node.build_node_columns output); `down` (bool[N]) marks nodes
        dead for the whole run."""
        n, p = self.n_nodes, self.payload_width
        w, b, v = self.wheel_rows, self.wheel_slots, self.overflow_capacity
        dev = self.device

        def i32(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int32), device=dev)

        def zi(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=dev)

        state = SimState(
            time=i32(0),
            seed=i32(np.int64(seed) & 0x7FFFFFFF),
            send_ctr=i32(0),
            down=torch.as_tensor(
                np.zeros(n, bool) if down is None else np.asarray(down, bool), device=dev
            ),
            done_at=zi(n),
            msg_received=zi(n),
            msg_sent=zi(n),
            bytes_received=zi(n),
            bytes_sent=zi(n),
            x=i32(cols["x"]),
            y=i32(cols["y"]),
            extra_latency=i32(cols["extra_latency"]),
            city_idx=i32(cols.get("city_idx", np.full(n, -1))),
            partition_x=torch.full((MAX_PARTITIONS,), INT_MAX, dtype=torch.int32, device=dev),
            msg_valid=torch.zeros((w, b), dtype=torch.bool, device=dev),
            msg_arrival=torch.full((w, b), INT_MAX, dtype=torch.int32, device=dev),
            msg_from=torch.zeros((w, b), dtype=self.lanes.idx, device=dev),
            msg_to=torch.zeros((w, b), dtype=self.lanes.idx, device=dev),
            msg_type=torch.zeros((w, b), dtype=self.lanes.mtype, device=dev),
            msg_payload=zi(w, b, p),
            whl_fill=zi(w),
            ovf_valid=torch.zeros(v, dtype=torch.bool, device=dev),
            ovf_arrival=torch.full((v,), INT_MAX, dtype=torch.int32, device=dev),
            ovf_from=torch.zeros(v, dtype=self.lanes.idx, device=dev),
            ovf_to=torch.zeros(v, dtype=self.lanes.idx, device=dev),
            ovf_type=torch.zeros(v, dtype=self.lanes.mtype, device=dev),
            ovf_payload=zi(v, p),
            msg_head=i32(0),
            dropped=i32(0),
            proto=proto,
            tele=(init_telemetry(self.telemetry, self.protocol.n_msg_types(), dev)
                  if self.telemetry is not None else ()),
            faults=(neutral_fault_state(n, self.protocol.n_msg_types(), dev)
                    if self.faults is not None else ()),
        )
        # the protocol's t=0 sends go through the batched send path as a
        # batch of one (its own seed, not replicate_state's 0..R-1)
        batch = map_state(lambda a: a.unsqueeze(0), state)
        emissions = self.protocol.initial_emissions(self, batch)
        if emissions:
            batch = self.apply_emissions(batch, emissions, 0)
            state = map_state(lambda a: a[0], batch)
        return state

    # -- partitions (Network.partition, Network.java:693-707) ----------------
    @staticmethod
    def partition_id(state: SimState, x_col: torch.Tensor) -> torch.Tensor:
        """pid = number of partition lines at or left of the node
        (Network.partitionId, Network.java:639-649); x_col is [R, ...]."""
        px = state.partition_x.view((x_col.shape[0],) + (1,) * (x_col.dim() - 1) + (-1,))
        return (px <= x_col[..., None]).sum(-1).to(torch.int32)

    # -- telemetry -------------------------------------------------------------
    def with_telemetry(self, state: SimState, telemetry: TelemetryConfig):
        """Instrument a built simulation: returns (an engine copy carrying
        the TelemetryConfig, the state with a counter side-car).  The
        side-car's per-mtype `sent` starts at the store's census, so the
        store invariant (sent == delivered + discarded + dropped +
        pending) holds from the first tick even when emissions predate
        the instrumentation.  Works on single and batched states."""
        import copy

        net = copy.copy(self)
        net.telemetry = telemetry
        t = self.protocol.n_msg_types()
        tele = init_telemetry(telemetry, t, self.device)
        lead = tuple(state.time.shape)
        if lead:
            tele = TelemetryState(*[a.expand(lead + tuple(a.shape)).contiguous() for a in tele])
        # the store's census per mtype: one masked count per type (T is
        # small) over the wheel [..., W, B] and the overflow lane [..., V]
        census = [
            ((state.msg_type == j) & state.msg_valid).sum((-2, -1))
            + ((state.ovf_type == j) & state.ovf_valid).sum(-1)
            for j in range(t)
        ]
        tele = tele._replace(sent=torch.stack(census, -1).to(torch.int32))
        return net, state._replace(tele=tele)

    # -- fault injection ------------------------------------------------------
    def with_faults(self, state: SimState, faults: Optional[FaultConfig] = None, plan=None):
        """Arm fault injection on a built simulation: returns (an engine
        copy carrying the FaultConfig, the state with a FaultState
        side-car).  `plan` is a host-side FaultPlan (lowered here), a
        lowered FaultState (e.g. a `lower_plans` stack, one schedule per
        replica) or None for the neutral schedule.  A single-replica
        schedule broadcasts over a batched state's replicas."""
        import copy

        net = copy.copy(self)
        net.faults = FaultConfig() if faults is None else faults
        t = self.protocol.n_msg_types()
        if plan is None:
            fs = neutral_fault_state(self.n_nodes, t, self.device)
        elif isinstance(plan, FaultState):
            fs = plan
        else:
            fs = plan.lower(self.n_nodes, t, self.device)
        lead = tuple(state.time.shape)
        if lead and fs.crash_at.dim() < 1 + len(lead):
            fs = FaultState(*[a.expand(lead + tuple(a.shape)).contiguous() for a in fs])
        return net, state._replace(faults=fs)

    # -- the send path (createMessageArrival, Network.java:469-487) ----------
    def latency_arrivals(self, state, mask, from_idx, to_idx, send_time, mtype, t: int):
        """The createMessageArrival kernel shared by the generic store and
        protocol-specific message channels: ticks sender counters (even for
        dropped sends, Network.java:476-477), samples the latency model via
        the counter RNG, applies the partition and down filters (the JAX
        package's discard-time filter has no caller and is not ported).
        mask is [R, K]; send_time an int or a tensor that broadcasts to
        [R, K]; mtype an int or a per-row tensor; `t` the tick that sends
        (the fault lanes' clock).  Returns (state, ok, arrival)."""
        state = state._replace(send_ctr=state.send_ctr + 1)
        return self._send_rows(state, mask, from_idx, to_idx, send_time, mtype,
                               state.send_ctr[:, None], t)

    def _send_rows(self, state, mask, from_idx, to_idx, send_time, mtype, ctr, t: int):
        """latency_arrivals' body, with the send counter each row hashes
        given as `ctr` (broadcasting to [R, K]) and send_ctr left as it is:
        rows of several emissions go through in one call, each row with
        its own emission's counter."""
        r, k = mask.shape
        from_idx = from_idx.to(torch.int32).expand(r, k)
        to_idx = to_idx.to(torch.int32).expand(r, k)
        if isinstance(mtype, torch.Tensor):
            mtype = mtype.to(torch.int32).expand(r, k)
            size = self._msg_sizes[mtype.to(torch.int64)]
        else:
            size = int(self._msg_sizes_host[int(mtype)])
        if isinstance(send_time, torch.Tensor):
            send_time = send_time.to(torch.int32).expand(r, k)
        m32 = mask.to(torch.int32)
        state = state._replace(
            msg_sent=add_at(state.msg_sent, from_idx, m32),
            bytes_sent=add_at(state.bytes_sent, from_idx, m32 * size),
        )
        # per-event seed: send_ctr decorrelates same-tick emissions, the
        # destination id the rows of one emission (the JAX package's
        # latency_arrivals explains the choice)
        seed = hash32(
            state.seed[:, None],
            send_time,
            from_idx,
            mtype,
            ctr,
            to_idx,
        )
        delta = pseudo_delta(to_idx, seed)
        static = LatencyStatic(state.x, state.y, state.extra_latency, state.city_idx)
        lat = vec_latency(self.latency, static, from_idx, to_idx, delta)
        arrival = (send_time + lat).to(torch.int32)
        pid_f = self.partition_id(state, take(state.x, from_idx))
        pid_t = self.partition_id(state, take(state.x, to_idx))
        ok = (
            mask
            & ~take(state.down, from_idx)
            & ~take(state.down, to_idx)
            & (pid_f == pid_t)
        )
        if self.faults is not None:
            # fault choke point 1 (send): the sender counters ticked above;
            # crash/partition/silence/drop suppress rows, inflation and
            # Byzantine delay rewrite the latency.  Each row's drop draw
            # hashes its own emission's counter `ctr`.  The JAX package's
            # discard-time filter (lat < INT_MAX by default) can fail only
            # on a rewritten latency, so only that one is filtered
            fs = state.faults
            mrows = mtype if isinstance(mtype, torch.Tensor) else torch.full_like(from_idx, mtype)
            lat_f = inflate_latency(self.faults, fs, t, from_idx, mrows, lat)
            supp = send_suppress(self.faults, fs, t, from_idx, to_idx, mrows,
                                 state.seed[:, None], ctr, send_time)
            ok_f = ok & ~supp & (lat_f < INT_MAX)
            state = state._replace(faults=fs._replace(
                dropped_by_fault=count_by_type(fs.dropped_by_fault, ok & supp, mrows),
                delayed_by_fault=count_by_type(fs.delayed_by_fault, ok_f & (lat_f != lat), mrows),
            ))
            ok = ok_f
            arrival = (send_time + lat_f).to(torch.int32)
        if self.telemetry is not None:
            # every send crosses this point (the generic store and the
            # protocols' channel sends alike), so per-mtype traffic is
            # counted here, after the fault lanes, as in the JAX package
            tele = state.tele
            mrows = mtype if isinstance(mtype, torch.Tensor) else torch.full_like(from_idx, mtype)
            state = state._replace(tele=tele._replace(
                lat_sent=count_by_type(tele.lat_sent, ok, mrows),
                lat_filtered=count_by_type(tele.lat_filtered, mask & ~ok, mrows),
            ))
        return state, ok, arrival

    def apply_emission(self, state: SimState, em: Emission, t: int) -> SimState:
        """Scatter one emission's ok-rows into the message store (see
        apply_emissions)."""
        return self.apply_emissions(state, [em], t)

    def apply_emissions(self, state: SimState, emissions, t: int) -> SimState:
        """Scatter a tick's emissions into the message store: wheel bucket
        `eff_arrival mod W` when the arrival is inside the horizon
        (t, t+W], the overflow lane otherwise or on full-row spill.  Wheel
        rows stay a dense prefix, so the next free slot is whl_fill[row]
        plus the same-row rank.  In the overflow lane the k-th ok row
        takes the k-th free slot; only a genuinely full store drops, and
        it drops the new rows, counted in `dropped`.

        The JAX package applies emissions one at a time; here the
        emissions' rows go through the send path and the insert together,
        concatenated in emission order, with the same result:
          * each emission that draws latencies takes the next send_ctr
            value, and its rows hash that value, as they would one by one
            (an explicit-arrival emission takes none); the sender counters
            are integer adds, whose order does not matter;
          * ranks, free-slot order and drops of the concatenation are
            those of the sequential inserts — a row an earlier emission
            filled rejects the later rows either way.
        So the store is copied once per tick instead of once per emission,
        and the hash runs once over all rows."""
        rows = [self._emission_rows(em, t) for em in emissions]
        if not rows:
            return state
        drawn = [rw for rw in rows if rw["arrival"] is None]
        if drawn:
            def cat(f):
                return torch.cat([rw[f] for rw in drawn], dim=1)

            ctr = torch.cat([
                torch.full_like(rw["mask"], j + 1, dtype=torch.int32)
                for j, rw in enumerate(drawn)
            ], dim=1)
            state, ok, arrival = self._send_rows(
                state, cat("mask"), cat("from_idx"), cat("to_idx"), cat("send_time"),
                cat("mtype"), state.send_ctr[:, None] + ctr, t,
            )
            state = state._replace(send_ctr=state.send_ctr + len(drawn))
            sizes = [rw["mask"].shape[1] for rw in drawn]
            for rw, o, a in zip(drawn, ok.split(sizes, 1), arrival.split(sizes, 1)):
                rw["ok"], rw["arrival"] = o, a
        fields = ("ok", "arrival", "from_idx", "to_idx", "mtype", "payload")
        cols = [
            torch.cat([rw[f] for rw in rows], dim=1) if rows[0][f] is not None else None
            for f in fields
        ]
        return self._insert(state, t, *cols)

    def _emission_rows(self, em: Emission, t: int) -> dict:
        """One emission's rows, [R, K] each (payload [R, K, P] or None);
        `arrival` is None until the send path draws it."""
        r, k = em.mask.shape
        dev = em.mask.device
        send_time = em.send_time if em.send_time is not None else t + 1
        if not isinstance(send_time, torch.Tensor):
            send_time = torch.tensor(int(send_time), dtype=torch.int32, device=dev)
        mtype = em.mtype
        if not isinstance(mtype, torch.Tensor):
            mtype = torch.tensor(int(mtype), dtype=torch.int32, device=dev)
        payload = None
        if self.payload_width:
            payload = (
                em.payload.to(torch.int32).expand(r, k, self.payload_width)
                if em.payload is not None
                else torch.zeros((r, k, self.payload_width), dtype=torch.int32, device=dev)
            )
        return {
            "mask": em.mask,
            # sendArriveAt: an explicit arrival skips the latency model and
            # the sender counters (Network.java:419-422)
            "ok": em.mask if em.arrival is not None else None,
            "arrival": None if em.arrival is None else em.arrival.to(torch.int32).expand(r, k),
            "from_idx": em.from_idx.to(torch.int32).expand(r, k),
            "to_idx": em.to_idx.to(torch.int32).expand(r, k),
            "send_time": send_time.to(torch.int32).expand(r, k),
            "mtype": mtype.to(torch.int32).expand(r, k),
            "payload": payload,
        }

    def _insert(self, state, t, ok, arrival, from_idx, to_idx, mtype_rows, payload):
        """The store insert of apply_emissions over [R, K] rows."""
        r, k = ok.shape
        v = self.overflow_capacity
        dev = ok.device
        n_ok = ok.sum(-1).to(torch.int32)

        if self.flat:
            to_ovf = ok
        else:
            state, fits = self._wheel_insert(
                state, t, ok, arrival, from_idx, to_idx, mtype_rows, payload
            )
            to_ovf = ok & ~fits  # beyond the horizon, or full-row spill

        # pack into FREE slots: the k-th ok row takes the k-th invalid slot
        free = ~state.ovf_valid  # [R, V]
        free_rank = free.to(torch.int32).cumsum(-1) - 1
        ar = torch.arange(v, dtype=torch.int64, device=dev).expand(r, v)
        slot_of_rank = torch.full((r, v + 1), v, dtype=torch.int64, device=dev)
        slot_of_rank = slot_of_rank.scatter(
            1, torch.where(free, free_rank.to(torch.int64), v), ar
        )
        n_free = free.sum(-1, keepdim=True)
        orank = to_ovf.to(torch.int32).cumsum(-1) - 1
        ofits = to_ovf & (orank < n_free)
        pos = torch.where(
            ofits,
            torch.gather(slot_of_rank, 1, orank.clamp(0, v).to(torch.int64)),
            v,  # past the end: the trash column below
        )
        overwritten = (to_ovf & ~ofits).sum(-1).to(torch.int32)

        def put(col, vals):
            ext = torch.cat([col, col[:, :1]], dim=1)
            return ext.scatter(1, pos, vals.to(col.dtype))[:, :v]

        state = state._replace(
            ovf_valid=put(state.ovf_valid, torch.ones_like(ok)),
            ovf_arrival=put(state.ovf_arrival, arrival),
            ovf_from=put(state.ovf_from, from_idx),
            ovf_to=put(state.ovf_to, to_idx),
            ovf_type=put(state.ovf_type, mtype_rows),
            msg_head=state.msg_head + n_ok,
            dropped=state.dropped + overwritten,
        )
        if self.payload_width:
            p = self.payload_width
            ext = torch.cat([state.ovf_payload, state.ovf_payload[:, :1]], dim=1)
            ext = ext.scatter(1, pos[..., None].expand(r, k, p), payload)
            state = state._replace(ovf_payload=ext[:, :v])
        if self.telemetry is not None:
            # every ok row is inserted or dropped (to_ovf & ~ofits, the
            # rows behind `overwritten`).  The JAX package samples the
            # high-water marks after each emission's insert; here a tick's
            # emissions go in together, and between the inserts of one
            # tick fill only grows, so the marks after the last insert
            # equal JAX's running max.  The flat store's wheel is never
            # filled: its mark stays 0
            tele = state.tele
            upd = dict(
                sent=count_by_type(tele.sent, ok, mtype_rows),
                dropped=count_by_type(tele.dropped, to_ovf & ~ofits, mtype_rows),
                ovf_hwm=torch.maximum(tele.ovf_hwm, state.ovf_valid.sum(-1).to(torch.int32)),
            )
            if not self.flat:
                upd["wheel_fill_hwm"] = torch.maximum(tele.wheel_fill_hwm,
                                                      state.whl_fill.amax(-1))
            state = state._replace(tele=tele._replace(**upd))
        return state

    def _wheel_insert(self, state, t, ok, arrival, from_idx, to_idx, mtype_rows, payload):
        """The wheel half of apply_emission; returns (state, fits)."""
        r, k = ok.shape
        w, b = self.wheel_rows, self.wheel_slots
        dev = ok.device
        # routing tick: stale arrivals (<= t, possible via explicit
        # arrivals after a clock skip) deliver next tick like the flat
        # store; arrival == t + W is safe because the current row is
        # delivered and cleared before emissions are applied
        eff = torch.clamp(arrival, min=t + 1)
        cand = ok & (eff <= t + w)
        row = torch.remainder(eff, w).to(torch.int64)
        # same-row rank: stable sort, then each entry's distance from the
        # first entry of its row (ties take distinct slots in row order)
        rkey = torch.where(cand, row, w)
        rsort, order = torch.sort(rkey, dim=1, stable=True)
        pos_sorted = torch.arange(k, device=dev) - torch.searchsorted(rsort, rsort)
        rank = torch.empty_like(order).scatter_(1, order, pos_sorted)
        slot = torch.gather(state.whl_fill, 1, torch.where(cand, row, 0)) + rank
        fits = cand & (slot < b)
        # positions in the flattened [R, W, B] wheel; rows that do not fit
        # go to set_rows' trash block
        cell = (torch.arange(r, device=dev)[:, None] * w + row) * b + slot
        cell, keep = cell.reshape(-1, 1), fits.reshape(-1)

        def put(col, vals):
            return set_rows(col, cell, vals.reshape(-1, 1), keep)

        fill = torch.cat([state.whl_fill, state.whl_fill.new_zeros(r, 1)], dim=1)
        fill = fill.scatter_add(1, torch.where(fits, row, w), fits.to(torch.int32))
        state = state._replace(
            msg_valid=put(state.msg_valid, torch.ones_like(ok)),
            msg_arrival=put(state.msg_arrival, arrival),
            msg_from=put(state.msg_from, from_idx),
            msg_to=put(state.msg_to, to_idx),
            msg_type=put(state.msg_type, mtype_rows),
            whl_fill=fill[:, :w].contiguous(),
        )
        if self.payload_width:
            p = self.payload_width
            pcell = cell * p + torch.arange(p, device=dev)
            state = state._replace(
                msg_payload=set_rows(state.msg_payload, pcell, payload.reshape(-1, p), keep)
            )
        return state, fits

    # -- delivery ------------------------------------------------------------
    def _window(self) -> int:
        """Wheel rows gathered per step: TIME_QUANTUM consecutive rows, so
        a quantum-coarsened step delivers its whole window (t-q, t] at
        once; 1 in flat mode (the overflow scan is already exact)."""
        if self.flat:
            return 1
        q = max(1, int(self.protocol.TIME_QUANTUM))
        if q > self.wheel_rows:
            raise ValueError(
                f"TIME_QUANTUM={q} exceeds wheel_rows={self.wheel_rows}; "
                "raise wheel_rows or use flat mode (wheel_rows=0)"
            )
        return q

    def delivery_view(self, state: SimState, t: int):
        """The flat delivery VIEW protocol.deliver sees: msg_* columns are
        [R, D] concatenations of the window's wheel rows and the overflow
        lane, ids and types widened to int32 (the one widening point of
        the narrow-lane plan).  Returns (vstate, due, deliver, rows,
        fault_supp): `due` is arrival <= t, `deliver` additionally applies
        the delivery-time down/partition discards (Network.java:606,
        :518-520) and the fault lanes', `rows` are the window's wheel rows,
        `fault_supp` the due rows the fault lanes discard (None without
        a FaultConfig)."""
        r = state.ovf_valid.shape[0]
        # the q distinct rows covering ticks (t-q, t]: floor modulo, since
        # t - q + 1 is negative near t = 0
        q = self._window()
        rows = torch.remainder(
            torch.arange(t - q + 1, t + 1, dtype=torch.int64, device=self.device),
            self.wheel_rows,
        )
        nq = q * self.wheel_slots

        def view(wheel, ovf):
            win = wheel.index_select(1, rows)
            return torch.cat([win.reshape((r, nq) + tuple(wheel.shape[3:])), ovf], 1)

        view_from = view(state.msg_from, state.ovf_from).to(torch.int32)
        view_to = view(state.msg_to, state.ovf_to).to(torch.int32)
        view_arrival = view(state.msg_arrival, state.ovf_arrival)
        due = view(state.msg_valid, state.ovf_valid) & (view_arrival <= t)
        pid_f = self.partition_id(state, take(state.x, view_from))
        pid_t = self.partition_id(state, take(state.x, view_to))
        deliver = due & ~take(state.down, view_to) & (pid_f == pid_t)
        fault_supp = None
        if self.faults is not None:
            # fault choke point 2 (arrival): a fault-crashed destination or
            # an active partition discards the row; it still leaves the
            # store like any other due row
            fault_supp = due & deliver_suppress(self.faults, state.faults, t, view_from, view_to)
            deliver = deliver & ~fault_supp
        vstate = state._replace(
            msg_valid=view(state.msg_valid, state.ovf_valid),
            msg_arrival=view_arrival,
            msg_from=view_from,
            msg_to=view_to,
            msg_type=view(state.msg_type, state.ovf_type).to(torch.int32),
            msg_payload=view(state.msg_payload, state.ovf_payload),
        )
        return vstate, due, deliver, rows, fault_supp

    def _deliver_and_clear(self, state: SimState, t: int):
        """One tick's delivery (the JAX package's fused form): gather the
        view, tick receiver counters (size-0 task types skipped,
        Network.java:522-526), run protocol.deliver on it, then clear the
        delivered entries.  Returns (state, emissions)."""
        vview, due, deliver, rows, fault_supp = self.delivery_view(state, t)
        view_to, view_type = vview.msg_to, vview.msg_type
        sizes = self._msg_sizes[view_type.to(torch.int64)]
        dm = deliver & (sizes > 0)
        received, bytes_received = add_masked((state.msg_received, state.bytes_received),
                                              view_to, (dm.to(torch.int32), sizes), dm)
        vstate = vview._replace(msg_received=received, bytes_received=bytes_received)
        if self.telemetry is not None:
            # due rows leave the store once, as delivered or as discards at
            # delivery (down destination, cross-partition, a fault lane)
            tele = vstate.tele
            vstate = vstate._replace(tele=tele._replace(
                delivered=count_by_type(tele.delivered, deliver, view_type),
                discarded=count_by_type(tele.discarded, due & ~deliver, view_type),
            ))
        if fault_supp is not None:
            fs = vstate.faults
            vstate = vstate._replace(faults=fs._replace(
                dropped_by_fault=count_by_type(fs.dropped_by_fault, fault_supp, view_type)))
        pstate, emissions = self.protocol.deliver(self, vstate, deliver, t)
        return self._clear_visited_rows(pstate, state, rows, due), emissions

    def _clear_visited_rows(self, pstate, state, rows, due) -> SimState:
        """Clear the due entries of the window's wheel rows and the
        overflow lane, and repack each row's surviving entries to its slot
        prefix so whl_fill stays the next free slot.  The wheel fields come
        from the pre-view `state`, everything else from the protocol's
        `pstate`.

        This is the JAX package's exact repack, for every window.  Its
        fused step replaces it, for a one-row window, by an empty-row fill
        that assumes every valid entry of the row is due; that holds for
        entries inserted inside a step, but an entry inserted before the
        first step at arrival t + W (by init_state, or a caller's
        apply_emission) sits in row t mod W unexpired and the fill loses
        it.  Where the assumption holds the two agree bit for bit."""
        r = state.ovf_valid.shape[0]
        q, b = rows.numel(), self.wheel_slots
        keep = state.msg_valid.index_select(1, rows) & ~due[:, : q * b].reshape(r, q, b)
        pos = keep.to(torch.int32).cumsum(2) - 1
        tgt = torch.where(keep, pos, b)  # past the end: the trash slot

        def repack(col, fill_value):
            win = col.index_select(1, rows)  # [R, q, B, ...]
            out = torch.full(
                (r, q, b + 1) + tuple(win.shape[3:]), fill_value,
                dtype=win.dtype, device=win.device,
            )
            idx = tgt.view(tgt.shape + (1,) * (win.dim() - 3)).expand(win.shape)
            return out.scatter_(2, idx, win)[:, :, :b]

        def set_window(col, vals):
            out = col.clone()
            out[:, rows] = vals
            return out

        # kept entries are valid, so repacking msg_valid itself gives the
        # JAX package's `.at[tgt].set(keep)`
        wheel = {"msg_valid": False, "msg_arrival": INT_MAX, "msg_from": 0, "msg_to": 0,
                 "msg_type": 0}
        if self.payload_width:
            wheel["msg_payload"] = 0
        upd = {f: set_window(getattr(state, f), repack(getattr(state, f), v))
               for f, v in wheel.items()}
        upd.setdefault("msg_payload", state.msg_payload)
        return pstate._replace(
            **upd,
            whl_fill=set_window(state.whl_fill, keep.sum(2).to(torch.int32)),
            ovf_valid=state.ovf_valid & ~due[:, q * b:],
            ovf_arrival=state.ovf_arrival,
            ovf_from=state.ovf_from,
            ovf_to=state.ovf_to,
            ovf_type=state.ovf_type,
            ovf_payload=state.ovf_payload,
        )

    # -- one millisecond (receiveUntil body, Network.java:586-632) -----------
    def _step_core(self, state: SimState, t: int) -> SimState:
        """One tick without tick_beat and without the time advance:
        delivery, emissions, protocol.tick."""
        state, emissions = self._deliver_and_clear(state, t)
        state = self.apply_emissions(state, emissions, t)
        return self.protocol.tick(self, state, t)

    def _tick(self, state: SimState, t: int) -> SimState:
        """One full tick on the ungated path: tick_beat runs every tick and
        masks itself to its beats."""
        state = self._step_core(state, t)
        state = self.protocol.tick_beat(self, state, t)
        state = self.protocol.tick_post(self, state, t)
        return self._tele_tick(state, t)

    def _tele_tick(self, state: SimState, t: int) -> SimState:
        """Per executed tick `t`: the tick census and, with a ring, the
        progress snapshot (the JAX package's _tele_tick, called before the
        time advance on every loop)."""
        if self.telemetry is None:
            return state
        tele = state.tele._replace(ticks=state.tele.ticks + 1)
        if self.telemetry.snapshots:
            tele = record_snapshot(tele, self.telemetry, state, t)
        return state._replace(tele=tele)

    # -- the phases the per-phase timing runs ----------------------------------
    def _phase_deliver(self, state: SimState, t: int) -> SimState:
        """Delivery + clear only, emissions discarded."""
        return self._deliver_and_clear(state, t)[0]

    def _phase_deliver_apply(self, state: SimState, t: int) -> SimState:
        """Delivery + emission apply (protocol.tick excluded)."""
        state, emissions = self._deliver_and_clear(state, t)
        return self.apply_emissions(state, emissions, t)

    # -- clocks ---------------------------------------------------------------
    @staticmethod
    def lockstep_time(states: SimState) -> int:
        """The replicas' shared clock as a host int (one device read);
        raises if the replicas' clocks differ."""
        times = states.time.reshape(-1).tolist()
        if not times or any(x != times[0] for x in times):
            raise ValueError(f"replicas must share one clock, got times {times}")
        return int(times[0])

    @staticmethod
    def _clock_groups(states: SimState) -> list:
        """The replicas grouped by clock, from one device read: a list of
        (clock, replica index tensor) in clock order, the index None when
        the whole batch shares one clock."""
        times = states.time.reshape(-1).tolist()
        if not times:
            raise ValueError("an empty batch has no clock")
        clocks = sorted(set(times))
        if len(clocks) == 1:
            return [(clocks[0], None)]
        dev = states.time.device
        return [(c, torch.tensor([i for i, x in enumerate(times) if x == c], device=dev))
                for c in clocks]

    @staticmethod
    def _rows(states: SimState, idx) -> SimState:
        """The replicas `idx` of a batch (all of them for None)."""
        return states if idx is None else map_state(lambda a: a.index_select(0, idx), states)

    @staticmethod
    def _merge(states: SimState, parts) -> SimState:
        """`states` with each (idx, sub-batch) of `parts` written back at
        its replicas (a whole-batch part, idx None, replaces it)."""
        for idx, sub in parts:
            states = sub if idx is None else map_state(
                lambda a, b, idx=idx: a.index_copy(0, idx, b), states, sub)
        return states

    def step(self, states: SimState) -> SimState:
        """Advance a batched state by one millisecond, each replica at its
        own clock."""
        parts = [(idx, self._tick(self._rows(states, idx), t))
                 for t, idx in self._clock_groups(states)]
        return self._merge(states, parts)._replace(time=states.time + 1)

    # -- occupancy summaries --------------------------------------------------
    def _wheel_next_arrival(self, state: SimState, t: int) -> torch.Tensor:
        """Earliest tick >= t with an occupied wheel row, per replica
        (INT_MAX if none): the occupancy bitmap (whl_fill > 0) rotated to
        start at tick t, packed into words in one pass, then a
        lowest-set-bit scan — O(W) instead of a min over all W*B slots.
        Row candidates equal the true arrival for in-horizon entries and
        never overshoot for stale ones, so jumps never skip a pending
        message."""
        words = pack_occupied(state.whl_fill, t % self.wheel_rows)  # [R, W/32]
        d = lowest_set_bit(words)
        # an empty row reads 32 from lowest_set_bit: the any() guard decides
        return torch.where(words.any(-1), t + d, INT_MAX).to(torch.int32)

    def pending_messages(self, state: SimState) -> torch.Tensor:
        """Quiescence summary per replica: occupied wheel rows (popcount
        over the packed occupancy words) plus live overflow entries.  Zero
        iff no message is pending — the DES "event queue empty" test."""
        ovf = state.ovf_valid.sum(-1).to(torch.int32)
        if self.flat:
            return ovf
        return popcount_words(pack_occupied(state.whl_fill, 0)) + ovf

    def occupancy(self, state: SimState) -> dict:
        """Observability: each replica's wheel-fill high-water and overflow
        census of the current state."""
        return {
            "wheel_fill_max": state.whl_fill.amax(-1),
            "overflow_count": state.ovf_valid.sum(-1).to(torch.int32),
        }

    def _step_jump(self, state: SimState, t: int, ends: torch.Tensor) -> SimState:
        """One full tick at t, then each replica jumps to its own next
        arrival: the wheel's occupancy-word scan plus a min over the small
        overflow lane, clipped to [t+1, end] and, for TIME_QUANTUM q > 1,
        rounded up to the quantum grid so a whole window of arrivals is
        delivered in one step (each delayed < q ms)."""
        state = self._tick(state, t)
        ovf_next = torch.where(state.ovf_valid, state.ovf_arrival, INT_MAX).amin(-1)
        nxt = ovf_next
        if not self.flat:
            nxt = torch.minimum(self._wheel_next_arrival(state, t + 1), ovf_next)
        nxt = torch.minimum(torch.clamp(nxt, min=t + 1), ends)
        q = self.protocol.TIME_QUANTUM
        if q > 1:
            nxt = torch.minimum(torch.div(nxt + q - 1, q, rounding_mode="floor") * q, ends)
        nxt = nxt.to(torch.int32)
        if self.telemetry is not None:
            # the jump census: JAX reads it against a clock already at t+1
            tele = state.tele
            gap = nxt - (t + 1)
            state = state._replace(tele=tele._replace(
                jumps=tele.jumps + (gap > 0).to(torch.int32),
                jumped_ms=tele.jumped_ms + gap,
            ))
        return state._replace(time=nxt)

    def _run_ms_jumps(self, states: SimState, ms: int, stop_when_done: bool) -> SimState:
        """The consensus-jump loop for event-driven protocols (the JAX
        package's _run_ms_batched_jumps): every iteration executes ONE
        replica-uniform tick t — the minimum clock over replicas still
        running, a host int from one device read — and the replicas whose
        clock is t take the step; the others are computed and discarded,
        keeping their state (send_ctr included, so their RNG streams do
        not move).  A replica steps iff t equals its own clock, and its
        clock moves only when it steps, so each replica executes exactly
        its own tick set; the JAX package pins this bit-identical to its
        default per-replica loop.  A replica stops at its horizon
        time + ms, or with stop_when_done once its all_done holds or no
        message is pending; every clock ends at its horizon.

        Observability: afterwards `jump_stats` holds the run's iteration
        count, each replica's last executed tick (-1 if none) — with
        stop_when_done, the tick its outcome was decided — and each
        replica's count of executed ticks."""
        proto = self.protocol
        ends = states.time + ms
        last_tick = torch.full_like(states.time, -1)
        ticks = torch.zeros_like(states.time)
        s, iterations = states, 0
        while True:
            alive = s.time < ends
            if stop_when_done:
                alive = alive & ~proto.all_done(s) & (self.pending_messages(s) > 0)
            t = int(torch.where(alive, s.time, INT_MAX).amin())
            if t == INT_MAX:
                break
            active = alive & (s.time == t)
            s = _lane_select(active, self._step_jump(s, t, ends), s)
            last_tick = torch.where(active, t, last_tick)
            ticks = ticks + active.to(torch.int32)
            iterations += 1
        self.jump_stats = {"iterations": iterations, "last_tick": last_tick, "ticks": ticks}
        return s._replace(time=ends)

    # -- the loops -------------------------------------------------------------
    def run_ms(self, states: SimState, ms: int, stop_when_done: bool = False) -> SimState:
        """Advance `ms` simulated milliseconds (ticks [time, time+ms)) on
        the ungated path: every tick runs tick_beat (the JAX package's
        vmapped `_run_ms_impl`).  stop_when_done stops each replica on its
        own once its `all_done` holds; its state freezes there while the
        others step on.  The clock ends at time + ms either way.  An
        event-driven protocol runs the consensus-jump loop instead."""
        if self.protocol.TICK_INTERVAL is None:
            return self._run_ms_jumps(states, ms, stop_when_done)
        parts = [(idx, self._run_ungated(self._rows(states, idx), t0, ms, stop_when_done))
                 for t0, idx in self._clock_groups(states)]
        return self._merge(states, parts)._replace(time=states.time + ms)

    def _run_ungated(self, s: SimState, t0: int, ms: int, stop_when_done: bool) -> SimState:
        """run_ms' loop over replicas that share clock t0; the clock leaf
        is left as it was."""
        for i in range(ms):
            if stop_when_done:
                alive = ~self.protocol.all_done(s)
                if not bool(alive.any()):
                    break
                s = _lane_select(alive, self._tick(s, t0 + i), s)
            else:
                s = self._tick(s, t0 + i)
        return s

    def run_ms_batched(self, states: SimState, ms: int,
                       stop_when_done: bool = False) -> SimState:
        """Advance `ms` milliseconds over the replica axis.

        With a sparse beat structure (BEAT_PERIOD + BEAT_RESIDUES), the
        lockstep loop runs tick_beat only on beat ticks — read from the
        host clock — and on the others advances send_ctr by
        BEAT_SEND_CALLS, so the RNG stream equals the ungated path's
        (engine/core.py:1344-1410 in the JAX package).
        stop_when_done stops the loop, before a tick, once every replica's
        all_done holds: one device read per tick, the tick the JAX
        while_loop stops at.  Otherwise the ungated `run_ms` runs, and an
        event-driven protocol the consensus-jump loop.

        Replicas whose clocks differ step in groups of one clock, each
        group at its own clock on every loop index; tick_beat fires for
        every group when any group's clock beats, as JAX's any-replica
        test fires it for every lane (tick_beat masks itself to each
        replica's own beats), and a group whose replicas are all done
        keeps stepping until the whole batch is."""
        proto = self.protocol
        period, residues = proto.BEAT_PERIOD, proto.BEAT_RESIDUES
        if proto.TICK_INTERVAL is None or not period or residues is None \
                or len(residues) >= period:
            return self.run_ms(states, ms, stop_when_done)
        residues = frozenset(int(r) for r in residues)
        groups = self._clock_groups(states)
        subs = [self._rows(states, idx) for _, idx in groups]
        for i in range(ms):
            if stop_when_done:
                done = [proto.all_done(s).all() for s in subs]
                if bool(done[0] if len(done) == 1 else torch.stack(done).all()):
                    break
            # lax.rem truncates toward zero, like math.fmod
            beat = any(int(math.fmod(t0 + i, period)) in residues for t0, _ in groups)
            for g, (t0, _) in enumerate(groups):
                t = t0 + i
                s = self._step_core(subs[g], t)
                if beat:
                    s = proto.tick_beat(self, s, t)
                else:
                    s = s._replace(send_ctr=s.send_ctr + proto.BEAT_SEND_CALLS)
                s = proto.tick_post(self, s, t)
                subs[g] = self._tele_tick(s, t)
        parts = [(idx, s) for (_, idx), s in zip(groups, subs)]
        return self._merge(states, parts)._replace(time=states.time + ms)

    def run_ms_occupancy(self, states: SimState, ms: int):
        """`ms` plain per-tick steps, no empty-ms jumps, so every tick's
        occupancy is sampled; returns (state, {"wheel_fill_hwm",
        "overflow_hwm"}), each replica's wheel-fill and overflow
        high-water marks over the run's ticks ([R] int32).  Each replica
        steps at its own clock."""
        parts, marks = [], []
        for t0, idx in self._clock_groups(states):
            s = self._rows(states, idx)
            hw_fill = torch.zeros_like(s.time)
            hw_ovf = torch.zeros_like(s.time)
            for i in range(ms):
                s = self._tick(s, t0 + i)
                hw_fill = torch.maximum(hw_fill, s.whl_fill.amax(-1))
                hw_ovf = torch.maximum(hw_ovf, s.ovf_valid.sum(-1).to(torch.int32))
            parts.append((idx, s))
            marks.append((idx, hw_fill, hw_ovf))
        fill = torch.zeros_like(states.time)
        ovf = torch.zeros_like(states.time)
        for idx, hw_fill, hw_ovf in marks:
            fill = hw_fill if idx is None else fill.index_copy(0, idx, hw_fill)
            ovf = hw_ovf if idx is None else ovf.index_copy(0, idx, hw_ovf)
        out = self._merge(states, parts)._replace(time=states.time + ms)
        return out, {"wheel_fill_hwm": fill, "overflow_hwm": ovf}


def replicate_state(state: SimState, n_replicas: int, seeds=None) -> SimState:
    """Tile a single-replica state along a new leading replica axis, giving
    each replica its own dynamics seed (0..R-1 by default)."""
    if seeds is None:
        seeds = np.arange(n_replicas, dtype=np.int32)
    tiled = map_state(
        lambda a: a.unsqueeze(0).expand((n_replicas,) + tuple(a.shape)).contiguous(), state
    )
    return tiled._replace(
        seed=torch.as_tensor(np.asarray(seeds, np.int32), device=state.seed.device)
    )


def stack_states(states) -> SimState:
    """Stack independently-built single-replica states (the analog of
    RunMultipleTimes' per-seed re-init)."""
    return map_state(lambda *xs: torch.stack(xs), *states)
