"""The fault schedule the engine carries: the device-side fault lanes.

Port of the JAX package's faults/state.py.  A `FaultState` side-car on
`SimState` holds, per replica, a crash/recovery window per node, a group
partition with one window, a per-mtype drop rate, a per-mtype latency
inflation, and a Byzantine silence mask and per-sender delay, with two
per-mtype counters.  Every lane is windowed on the tick `t` with the
convention `active(t) = start <= t < end` (INT_MAX start = never).

The engine applies the lanes at its two choke points: at send
(`send_suppress`, `inflate_latency`), on every row that crosses the
latency model, and at delivery (`deliver_suppress`), on the store's due
rows.  A suppressed send still ticks the sender's counters, as in the
reference.  The drop draw hashes its own stream, salted with
FAULT_STREAM, so every base latency draw is untouched.

Neutrality is the contract: with `neutral_fault_state` every predicate is
constant-false and every latency passes through unchanged, so a run with
the lanes armed is bit-identical in every other leaf to one without.  The
switch is the engine's `FaultConfig`; with `faults=None` the engine runs
no fault op at all and the state carries `faults=()`.

Every leaf carries the replica axis R in front once the state is batched;
node-indexed leaves are [R, N], mtype-indexed [R, T], windows [R].
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..ops.indexing import take
from ..telemetry.state import count_by_type  # noqa: F401  (the one copy, shared by both side-cars)

INT_MAX = 2**31 - 1

# salt of the drop draw's hash32 stream: decorrelates fault draws from the
# latency draws that share (seed, send_time, from, mtype, send_ctr, to)
FAULT_STREAM = 0x5AFE


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Which fault lanes the engine runs; a lane that is off runs no op."""

    crashes: bool = True
    partitions: bool = True
    drops: bool = True
    delays: bool = True  # latency inflation lane
    byzantine: bool = True  # silence + per-sender delay masks

    def __post_init__(self):
        if not any(self.key()):
            raise ValueError(
                "FaultConfig with every lane disabled runs zero fault ops; "
                "pass faults=None to the engine instead"
            )

    def key(self) -> tuple:
        return (self.crashes, self.partitions, self.drops, self.delays, self.byzantine)


class FaultState(NamedTuple):
    """The fault schedule and its counters (int32 and bool tensors): [N]
    one row per node, [T] one row per message type, window bounds scalar,
    each with the replica axis in front in a batched state."""

    # crash lane [N]: crashed(i, t) = crash_at[i] <= t < recover_at[i]
    crash_at: torch.Tensor
    recover_at: torch.Tensor
    # partition lane: group map [N] + one window
    group: torch.Tensor
    part_start: torch.Tensor
    part_end: torch.Tensor
    # probabilistic drop lane [T] (per mille) + window
    drop_pm: torch.Tensor
    drop_start: torch.Tensor
    drop_end: torch.Tensor
    # latency inflation lane [T]: lat' = lat * infl_pm // 1000 + infl_add
    infl_pm: torch.Tensor
    infl_add: torch.Tensor
    infl_start: torch.Tensor
    infl_end: torch.Tensor
    # Byzantine lane [N] + window
    byz_silent: torch.Tensor  # bool[N]: the sender emits nothing in-window
    byz_delay: torch.Tensor  # int32[N]: ms added to its outgoing latency
    byz_start: torch.Tensor
    byz_end: torch.Tensor
    # counters [T]
    dropped_by_fault: torch.Tensor  # sends and deliveries a fault suppressed
    delayed_by_fault: torch.Tensor  # sends whose latency a fault changed


def neutral_fault_state(n_nodes: int, n_msg_types: int, device=None) -> FaultState:
    """The do-nothing schedule of one replica: every window starts at
    INT_MAX, drop rate 0, inflation multiplier 1000 (identity)."""
    n, t = n_nodes, n_msg_types

    def full(shape, value, dtype=torch.int32):
        return torch.full(shape, value, dtype=dtype, device=device)

    return FaultState(
        crash_at=full((n,), INT_MAX), recover_at=full((n,), INT_MAX),
        group=full((n,), 0), part_start=full((), INT_MAX), part_end=full((), INT_MAX),
        drop_pm=full((t,), 0), drop_start=full((), INT_MAX), drop_end=full((), INT_MAX),
        infl_pm=full((t,), 1000), infl_add=full((t,), 0),
        infl_start=full((), INT_MAX), infl_end=full((), INT_MAX),
        byz_silent=full((n,), False, torch.bool), byz_delay=full((n,), 0),
        byz_start=full((), INT_MAX), byz_end=full((), INT_MAX),
        dropped_by_fault=full((t,), 0), delayed_by_fault=full((t,), 0),
    )


def stack_fault_states(states) -> FaultState:
    """Stack per-replica schedules along a new leading replica axis."""
    return FaultState(*[torch.stack(xs) for xs in zip(*states)])


# -- the lane predicates (the engine's two choke points) ---------------------
def _col(x: torch.Tensor) -> torch.Tensor:
    """A per-replica window bound [R] against [R, K] rows."""
    return x[:, None]


def window_active(start, end, t):
    return (start <= t) & (t < end)


def node_crashed(fs: FaultState, idx, t):
    return (take(fs.crash_at, idx) <= t) & (t < take(fs.recover_at, idx))


def send_suppress(cfg: FaultConfig, fs: FaultState, t: int, from_idx, to_idx, mtype_rows,
                  seed, send_ctr, send_time):
    """bool[R, K]: the rows the fault lanes kill at send.  The crash
    predicate reads the tick `t` that emits the row, not its send time (a
    node alive at t sends what it emits at t).  `send_ctr` is each row's
    own emission counter ([R, K] or broadcasting to it)."""
    supp = torch.zeros(from_idx.shape, dtype=torch.bool, device=from_idx.device)
    if cfg.crashes:
        # both endpoints, like the reference's send-time is_down() pair
        supp = supp | node_crashed(fs, from_idx, t) | node_crashed(fs, to_idx, t)
    if cfg.partitions:
        cross = take(fs.group, from_idx) != take(fs.group, to_idx)
        supp = supp | (window_active(_col(fs.part_start), _col(fs.part_end), t) & cross)
    if cfg.byzantine:
        supp = supp | (window_active(_col(fs.byz_start), _col(fs.byz_end), t)
                       & take(fs.byz_silent, from_idx))
    if cfg.drops:
        from ..engine.rng import hash32_u  # the engine package imports this module

        # a stream of its own, and send_ctr not advanced: drop_pm = 0 rows
        # are bit-identical to a fault-free run
        u = hash32_u(seed, FAULT_STREAM, send_time, from_idx, mtype_rows, send_ctr, to_idx)
        draw = torch.remainder(u, 1000).to(torch.int32)
        supp = supp | (window_active(_col(fs.drop_start), _col(fs.drop_end), t)
                       & (draw < take(fs.drop_pm, mtype_rows)))
    return supp


def inflate_latency(cfg: FaultConfig, fs: FaultState, t: int, from_idx, mtype_rows, lat):
    """int32[R, K]: the sampled latency after the inflation and Byzantine
    delay lanes; outside their windows both pass the latency through."""
    new = lat
    if cfg.delays:
        act = window_active(_col(fs.infl_start), _col(fs.infl_end), t)
        inflated = torch.div(lat * take(fs.infl_pm, mtype_rows), 1000, rounding_mode="floor") \
            + take(fs.infl_add, mtype_rows)
        new = torch.where(act, inflated.to(torch.int32), new)
    if cfg.byzantine:
        bact = window_active(_col(fs.byz_start), _col(fs.byz_end), t)
        new = new + torch.where(bact, take(fs.byz_delay, from_idx), 0)
    return new.to(torch.int32)


def deliver_suppress(cfg: FaultConfig, fs: FaultState, t: int, view_from, view_to):
    """bool[R, D]: the due rows the fault lanes discard on arrival: the
    destination's crash (a message in flight from a node that crashed
    after sending still arrives) and an active partition."""
    supp = torch.zeros(view_to.shape, dtype=torch.bool, device=view_to.device)
    if cfg.crashes:
        supp = supp | node_crashed(fs, view_to, t)
    if cfg.partitions:
        cross = take(fs.group, view_from) != take(fs.group, view_to)
        supp = supp | (window_active(_col(fs.part_start), _col(fs.part_end), t) & cross)
    return supp
