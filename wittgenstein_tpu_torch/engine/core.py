"""Batched time-stepped simulation core, the main-path subset.

Re-expression of the reference DES (core Network.java) as a synchronous
per-millisecond state transition, ported from the JAX package's
engine/core.py:

  * node state is a struct-of-arrays of `[R, N]` columns — the replica
    axis R is carried explicitly in every tensor, where the JAX package
    writes one replica and `vmap`s it;
  * per-destination latency jitter comes from the reference's own xorshift
    counter hash (rng.pseudo_delta), so multicast costs no per-dest state;
  * one tick delivers every due message, runs the protocol's vectorized
    hooks and appends emissions; the loop over milliseconds is a host loop
    whose clock `t` is a Python int, mirrored from `state.time` once per
    call — every entry point asserts that all replicas share one time.

The port supports the flat message store only (`wheel_rows=0`: every
message goes through the overflow lane, the old full-scan ring), per-ms
ticking protocols (TICK_INTERVAL 1), and no fault or telemetry side-cars;
it raises on anything else.  Its one step is the JAX package's fused step
(`fuse_step=True`), which is bit-identical to the unfused one there.

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
from ..ops.indexing import add_at, take
from .density import lane_plan
from .rng import hash32, pseudo_delta

MAX_PARTITIONS = 4
INT_MAX = 2**31 - 1


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
    # time wheel [W, B]; degenerate 1x1 in flat mode, never occupied
    msg_valid: torch.Tensor  # bool[W, B]
    msg_arrival: torch.Tensor  # int32[W, B]
    msg_from: torch.Tensor  # lanes.idx[W, B]
    msg_to: torch.Tensor  # lanes.idx[W, B]
    msg_type: torch.Tensor  # lanes.mtype[W, B]
    msg_payload: torch.Tensor  # int32[W, B, P]
    whl_fill: torch.Tensor  # int32[W]
    # overflow lane [V]: in flat mode, the whole message store
    ovf_valid: torch.Tensor  # bool[V]
    ovf_arrival: torch.Tensor  # int32[V]
    ovf_from: torch.Tensor  # lanes.idx[V]
    ovf_to: torch.Tensor  # lanes.idx[V]
    ovf_type: torch.Tensor  # lanes.mtype[V]
    ovf_payload: torch.Tensor  # int32[V, P]
    msg_head: torch.Tensor  # int32: monotone sent-message counter
    dropped: torch.Tensor  # int32: store overflow count
    proto: Any  # protocol-defined dict of tensors
    tele: Any = ()  # telemetry side-car: not ported, always empty
    faults: Any = ()  # fault side-car: not ported, always empty


def map_state(fn, *states: SimState) -> SimState:
    """Apply fn leaf-wise over SimStates of the same structure (proto dict
    leaves included; empty side-cars pass through)."""
    out = {}
    for f in SimState._fields:
        vals = [getattr(s, f) for s in states]
        if isinstance(vals[0], dict):
            out[f] = {k: fn(*[v[k] for v in vals]) for k in vals[0]}
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
    P=0).  mtype is a static int or a per-row [R, K] tensor.  arrival,
    when given, bypasses the latency model and sender counters
    (sendArriveAt, Network.java:419-422)."""

    mask: torch.Tensor
    from_idx: torch.Tensor
    to_idx: torch.Tensor
    mtype: "int | torch.Tensor"
    payload: Optional[torch.Tensor] = None
    send_time: "int | torch.Tensor | None" = None  # default: t + 1
    arrival: Optional[torch.Tensor] = None  # explicit arrival times [R, K]


class BatchedNetwork:
    """The engine: binds a latency model and a protocol to the step and
    run functions.  One instance serves any replica count (everything
    batched lives in SimState)."""

    def __init__(
        self,
        protocol,
        latency: NetworkLatency,
        n_nodes: int,
        capacity: int = 1 << 14,
        wheel_rows: int = 0,
        telemetry=None,
        faults=None,
        batched_jumps: bool = False,
        device=None,
    ):
        if wheel_rows != 0:
            raise NotImplementedError("the port runs the flat store only (wheel_rows=0)")
        if telemetry is not None:
            raise NotImplementedError("telemetry is not ported")
        if faults is not None:
            raise NotImplementedError("fault injection is not ported")
        if batched_jumps:
            raise NotImplementedError("batched consensus jumps are not ported")
        if protocol.TICK_INTERVAL != 1:
            raise NotImplementedError("the port runs per-ms ticking protocols only")
        self.device = resolve_device(device)
        self.protocol = protocol
        self.latency = latency
        self.n_nodes = n_nodes
        self.capacity = capacity
        self.payload_width = protocol.PAYLOAD_WIDTH
        sizes = [protocol.msg_size(t) for t in range(protocol.n_msg_types())]
        self._msg_sizes_host = np.asarray(sizes, dtype=np.int32)
        self._msg_sizes = torch.tensor(sizes, dtype=torch.int32, device=self.device)
        self.lanes = lane_plan(n_nodes, protocol.n_msg_types())
        # flat mode: a degenerate 1x1 wheel keeps the state's shape the JAX
        # package's; inserts never target it
        self.wheel_rows = 1
        self.wheel_slots = 1
        self.overflow_capacity = capacity

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

    # -- the send path (createMessageArrival, Network.java:469-487) ----------
    def latency_arrivals(self, state, mask, from_idx, to_idx, send_time, mtype):
        """The createMessageArrival kernel shared by the generic store and
        protocol-specific message channels: ticks sender counters (even for
        dropped sends, Network.java:476-477), samples the latency model via
        the counter RNG, applies the partition and down filters (the JAX
        package's discard-time filter has no caller and is not ported).
        mask is [R, K]; send_time an int or [R] tensor; mtype an int or a
        per-row tensor.  Returns (state, ok, arrival)."""
        r, k = mask.shape
        from_idx = from_idx.to(torch.int32).expand(r, k)
        to_idx = to_idx.to(torch.int32).expand(r, k)
        if isinstance(mtype, torch.Tensor):
            mtype = mtype.to(torch.int32).expand(r, k)
            size = self._msg_sizes[mtype.to(torch.int64)]
        else:
            size = int(self._msg_sizes_host[int(mtype)])
        if isinstance(send_time, torch.Tensor):
            send_time = send_time.to(torch.int32)[:, None]
        m32 = mask.to(torch.int32)
        state = state._replace(
            msg_sent=add_at(state.msg_sent, from_idx, m32),
            bytes_sent=add_at(state.bytes_sent, from_idx, m32 * size),
            send_ctr=state.send_ctr + 1,
        )
        # per-event seed: send_ctr decorrelates same-tick emissions, the
        # destination id the rows of one emission (the JAX package's
        # latency_arrivals explains the choice)
        seed = hash32(
            state.seed[:, None],
            send_time,
            from_idx,
            mtype,
            state.send_ctr[:, None],
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
        return state, ok, arrival

    def apply_emission(self, state: SimState, em: Emission, t: int) -> SimState:
        """Scatter an emission's ok-rows into the flat store: the k-th ok row
        takes the k-th free overflow slot; only a genuinely full store
        drops, and it drops the new rows, counted in `dropped`."""
        r, k = em.mask.shape
        v = self.overflow_capacity
        dev = em.mask.device
        send_time = em.send_time if em.send_time is not None else t + 1
        mask = em.mask
        from_idx = em.from_idx.to(torch.int32).expand(r, k)
        to_idx = em.to_idx.to(torch.int32).expand(r, k)
        mtype = em.mtype
        if em.arrival is not None:
            # sendArriveAt: explicit arrival, no latency model and no
            # sender counters (Network.java:419-422)
            arrival = em.arrival.to(torch.int32).expand(r, k)
            ok = mask
        else:
            state, ok, arrival = self.latency_arrivals(
                state, mask, from_idx, to_idx, send_time, mtype
            )
        mtype_rows = (
            mtype.to(torch.int32).expand(r, k)
            if isinstance(mtype, torch.Tensor)
            else torch.full((r, k), int(mtype), dtype=torch.int32, device=dev)
        )
        n_ok = ok.sum(-1).to(torch.int32)
        to_ovf = ok

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
            payload = (
                em.payload
                if em.payload is not None
                else torch.zeros((r, k, p), dtype=torch.int32, device=dev)
            )
            ext = torch.cat([state.ovf_payload, state.ovf_payload[:, :1]], dim=1)
            ext = ext.scatter(1, pos[..., None].expand(r, k, p), payload.to(torch.int32))
            state = state._replace(ovf_payload=ext[:, :v])
        return state

    def apply_emissions(self, state: SimState, emissions, t: int) -> SimState:
        for em in emissions:
            state = self.apply_emission(state, em, t)
        return state

    # -- delivery ------------------------------------------------------------
    def delivery_view(self, state: SimState, t: int):
        """The flat delivery VIEW protocol.deliver sees: msg_* columns are
        [R, D] concatenations of the (never occupied) wheel row and the
        overflow lane, ids and types widened to int32.  Returns
        (vstate, due, deliver): `due` is arrival <= t, `deliver`
        additionally applies the delivery-time down/partition discards
        (Network.java:606, :518-520)."""
        r = state.ovf_valid.shape[0]
        view_valid = torch.cat([state.msg_valid.reshape(r, -1), state.ovf_valid], 1)
        view_arrival = torch.cat([state.msg_arrival.reshape(r, -1), state.ovf_arrival], 1)
        view_from = torch.cat([state.msg_from.reshape(r, -1), state.ovf_from], 1).to(torch.int32)
        view_to = torch.cat([state.msg_to.reshape(r, -1), state.ovf_to], 1).to(torch.int32)
        view_type = torch.cat([state.msg_type.reshape(r, -1), state.ovf_type], 1).to(torch.int32)
        view_payload = torch.cat(
            [state.msg_payload.reshape(r, self.wheel_rows * self.wheel_slots, self.payload_width),
             state.ovf_payload], 1
        )
        due = view_valid & (view_arrival <= t)
        pid_f = self.partition_id(state, take(state.x, view_from))
        pid_t = self.partition_id(state, take(state.x, view_to))
        deliver = due & ~take(state.down, view_to) & (pid_f == pid_t)
        vstate = state._replace(
            msg_valid=view_valid,
            msg_arrival=view_arrival,
            msg_from=view_from,
            msg_to=view_to,
            msg_type=view_type,
            msg_payload=view_payload,
        )
        return vstate, due, deliver

    def _deliver_and_clear(self, state: SimState, t: int):
        """One tick's delivery (the JAX package's fused form): gather the
        view, tick receiver counters (size-0 task types skipped,
        Network.java:522-526), run protocol.deliver on it, then clear the
        delivered entries.  Returns (state, emissions)."""
        vview, due, deliver = self.delivery_view(state, t)
        view_to, view_type = vview.msg_to, vview.msg_type
        sizes = self._msg_sizes[view_type.to(torch.int64)]
        dm = (deliver & (sizes > 0)).to(torch.int32)
        vstate = vview._replace(
            msg_received=add_at(state.msg_received, view_to, dm),
            bytes_received=add_at(state.bytes_received, view_to, dm * sizes),
        )
        pstate, emissions = self.protocol.deliver(self, vstate, deliver, t)
        # flat mode: the degenerate wheel row is all-due by construction, so
        # the clear is a constant fill; the overflow lane drops its due rows
        nb = state.msg_valid[0].numel()
        state = pstate._replace(
            msg_valid=torch.zeros_like(state.msg_valid),
            msg_arrival=torch.full_like(state.msg_arrival, INT_MAX),
            msg_from=torch.zeros_like(state.msg_from),
            msg_to=torch.zeros_like(state.msg_to),
            msg_type=torch.zeros_like(state.msg_type),
            msg_payload=torch.zeros_like(state.msg_payload),
            whl_fill=torch.zeros_like(state.whl_fill),
            ovf_valid=state.ovf_valid & ~due[:, nb:],
            ovf_arrival=state.ovf_arrival,
            ovf_from=state.ovf_from,
            ovf_to=state.ovf_to,
            ovf_type=state.ovf_type,
            ovf_payload=state.ovf_payload,
        )
        return state, emissions

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
        return self.protocol.tick_post(self, state, t)

    @staticmethod
    def lockstep_time(states: SimState) -> int:
        """The replicas' shared clock as a host int (one device read);
        raises if the replicas' clocks differ."""
        times = states.time.reshape(-1).tolist()
        if not times or any(x != times[0] for x in times):
            raise ValueError(f"replicas must share one clock, got times {times}")
        return int(times[0])

    def step(self, states: SimState) -> SimState:
        """Advance a batched state by one millisecond."""
        t = self.lockstep_time(states)
        return self._tick(states, t)._replace(time=states.time + 1)

    # -- the loops -------------------------------------------------------------
    def run_ms(self, states: SimState, ms: int, stop_when_done: bool = False) -> SimState:
        """Advance `ms` simulated milliseconds (ticks [time, time+ms)) on
        the ungated path: every tick runs tick_beat (the JAX package's
        vmapped `_run_ms_impl`).  stop_when_done stops each replica on its
        own once its `all_done` holds; its state freezes there while the
        others step on.  The clock ends at time + ms either way."""
        t0 = self.lockstep_time(states)
        s = states
        for i in range(ms):
            if stop_when_done:
                alive = ~self.protocol.all_done(s)
                if not bool(alive.any()):
                    break
                s = _lane_select(alive, self._tick(s, t0 + i), s)
            else:
                s = self._tick(s, t0 + i)
        return s._replace(time=states.time + ms)

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
        while_loop stops at.  Otherwise the ungated `run_ms` runs."""
        proto = self.protocol
        period, residues = proto.BEAT_PERIOD, proto.BEAT_RESIDUES
        if not period or residues is None or len(residues) >= period:
            return self.run_ms(states, ms, stop_when_done)
        residues = frozenset(int(r) for r in residues)
        t0 = self.lockstep_time(states)
        s = states
        for i in range(ms):
            if stop_when_done and bool(proto.all_done(s).all()):
                break
            t = t0 + i
            s = self._step_core(s, t)
            # lax.rem truncates toward zero, like math.fmod
            if int(math.fmod(t, period)) in residues:
                s = proto.tick_beat(self, s, t)
            else:
                s = s._replace(send_ctr=s.send_ctr + proto.BEAT_SEND_CALLS)
            s = proto.tick_post(self, s, t)
        return s._replace(time=states.time + ms)


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
