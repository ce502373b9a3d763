"""The telemetry side-car's state: device-side counters and the snapshot
ring.

Port of the JAX package's telemetry/state.py.  The counters live in a
`TelemetryState` side-car on `SimState`, updated where the engine
already touches the rows:

  * per-mtype message-store counters (sent / delivered / discarded /
    dropped), at the store insert and the delivery view;
  * per-mtype latency-path counters (`lat_sent` / `lat_filtered`) at the
    send path, which every send crosses, the aggregation protocols'
    channel sends included;
  * the wheel and overflow high-water marks and the loop census (ticks,
    empty-ms jumps and the ms they skipped);
  * an optional ring of progress snapshots, one slot per
    `snapshot_every_ms` window of simulated time, so a progress curve
    comes off the device in one read at the end of a run.

Everything here is accounting: no other leaf is read-modified and no RNG
is drawn, so every other leaf of an instrumented run equals the plain
run's.  The switch is static: an engine without a `TelemetryConfig`
runs no telemetry op and its states carry `tele=()`.

Store invariant, per replica:

    sent == delivered + discarded + dropped + pending

where `pending` is the live store census (export.pending_count) and
`discarded` counts the due rows dropped at delivery (down destination,
cross-partition, a fault lane).

Every leaf of a batched state carries the replica axis R in front, as
every other SimState leaf does.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Static telemetry knobs.

    snapshots: ring slots S for the progress time-series (0 = counters
    only).  One slot per `snapshot_every_ms` window, written at every
    executed tick at slot `tick // every mod S`; a run longer than
    S * every wraps and keeps the most recent S windows (snap_time tells
    them apart; export.progress_series sorts them)."""

    snapshots: int = 0
    snapshot_every_ms: int = 10

    def __post_init__(self):
        if self.snapshots < 0:
            raise ValueError(f"snapshots={self.snapshots} must be >= 0")
        if self.snapshot_every_ms <= 0:
            raise ValueError(f"snapshot_every_ms={self.snapshot_every_ms} must be > 0")

    def key(self) -> tuple:
        return (self.snapshots, self.snapshot_every_ms)


class TelemetryState(NamedTuple):
    """The counter side-car, every leaf int32 with the JAX package's name
    and shape ([T] one row per message type, [S] one per ring slot),
    behind the replica axis on a batched state."""

    # message-store counters [T]
    sent: torch.Tensor  # rows accepted into the wheel or the overflow lane
    delivered: torch.Tensor  # rows removed from the store and delivered
    discarded: torch.Tensor  # due rows dropped at delivery
    dropped: torch.Tensor  # per-mtype twin of SimState.dropped (store full)
    # latency-path counters [T] (the generic store and protocol channels)
    lat_sent: torch.Tensor  # ok sends through the send path
    lat_filtered: torch.Tensor  # masked-in sends the send path filtered
    # occupancy high-water marks and the loop census (scalars)
    wheel_fill_hwm: torch.Tensor  # max whl_fill seen after an insert
    ovf_hwm: torch.Tensor  # max live overflow entries after an insert
    ticks: torch.Tensor  # executed engine ticks
    jumps: torch.Tensor  # empty-ms jumps taken
    jumped_ms: torch.Tensor  # ms skipped by those jumps
    # progress snapshot ring [S] (S may be 0)
    snap_time: torch.Tensor  # last executed tick in the window, -1 = never
    snap_done: torch.Tensor  # nodes with done_at > 0
    snap_pending: torch.Tensor  # store-pending messages (counter diff)
    snap_sent: torch.Tensor  # cumulative node msg_sent sum
    snap_delivered: torch.Tensor  # cumulative node msg_received sum


def init_telemetry(cfg: TelemetryConfig, n_msg_types: int, device=None) -> TelemetryState:
    """A zeroed single-replica side-car (snap_time -1: no slot written)."""
    t, s = n_msg_types, cfg.snapshots

    def z(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    return TelemetryState(
        sent=z(t), delivered=z(t), discarded=z(t), dropped=z(t),
        lat_sent=z(t), lat_filtered=z(t),
        wheel_fill_hwm=z(), ovf_hwm=z(), ticks=z(), jumps=z(), jumped_ms=z(),
        snap_time=torch.full((s,), -1, dtype=torch.int32, device=device),
        snap_done=z(s), snap_pending=z(s), snap_sent=z(s), snap_delivered=z(s),
    )


def count_by_type(counts: torch.Tensor, mask: torch.Tensor, mtype_rows: torch.Tensor):
    """counts [..., T] plus the per-mtype census of the masked rows
    [..., K]: one masked reduction over the rows' one-hot types
    [..., K, T], so no row scatters onto a shared cell and the launches
    do not grow with T.  Rows whose mtype lies outside [0, T) are not
    counted, as the JAX package's drop-mode scatter drops them."""
    types = torch.arange(counts.shape[-1], dtype=mtype_rows.dtype, device=counts.device)
    hits = (mtype_rows.unsqueeze(-1) == types) & mask.unsqueeze(-1)
    return counts + hits.sum(-2).to(counts.dtype)


def pending_scalar(tele: TelemetryState) -> torch.Tensor:
    """Store-pending message count as a counter diff, per replica: O(T),
    no store scan (export.pending_count is the exact census; the store
    invariant makes them agree)."""
    return (tele.sent - tele.delivered - tele.discarded - tele.dropped).sum(-1).to(torch.int32)


def record_snapshot(tele: TelemetryState, cfg: TelemetryConfig, state, t: int) -> TelemetryState:
    """Write the progress sample of executed tick `t` (a host int) into
    its window's slot; later ticks of the window overwrite it, so the slot
    ends up holding the window's last executed tick, which equals the
    window-end state because jumped ticks change nothing.  The slot and
    snap_time come from `t`: the loops advance `state.time` only at the
    end of a run."""
    slot = (t // cfg.snapshot_every_ms) % cfg.snapshots

    def put(col, vals):
        out = col.clone()
        out[..., slot] = vals
        return out

    def total(col):
        return col.sum(-1).to(torch.int32)

    return tele._replace(
        snap_time=put(tele.snap_time, t),
        snap_done=put(tele.snap_done, total(state.done_at > 0)),
        snap_pending=put(tele.snap_pending, pending_scalar(tele)),
        snap_sent=put(tele.snap_sent, total(state.msg_sent)),
        snap_delivered=put(tele.snap_delivered, total(state.msg_received)),
    )
