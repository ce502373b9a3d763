"""Runtime invariant sentinel: a host-side hook the Supervisor calls at
its per-chunk sync boundary, checking on the live run:

1. **store invariant** (telemetry on): `sent == delivered + discarded +
   dropped + pending` in aggregate, and per message type `sent >=
   delivered + discarded + dropped` (an overshoot names the type whose
   accounting broke);
2. **capacity promise**: if the capacity table has an entry for this
   protocol@N with `dropped: 0`, the live run must drop zero too; a
   violation names the protocol, the worst message type and the worst
   replica row;
3. **HWM headroom**: the observed wheel/overflow high-water marks must
   stay below the entry's sized limits;
4. **attribution reconciliation**: per-replica tick counts must sum
   exactly to the loop's total ticks (per-tenant ticks to `ticks_live`
   when the batch's members are given).

Violations alert (an `invariant-violation` flight-recorder event, or an
engine's `fire_violation` when one is given) and never raise: a
monitoring bug or a broken invariant must not kill the run it watches.
Each invariant fires at most once per sentinel (latched).

The sentinel reads only the leaves it checks (`done_at`, `dropped`,
`msg_valid`/`ovf_valid` and the `tele` counters), copied to the host;
it never copies the whole state and never changes it, so arming it is
bitwise-neutral.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Dict, List, Optional

import numpy as np

from ..engine.capacity import capacity_path
from .attribution import batch_attribution, host, replica_rows


def load_capacity_table(root: Optional[str] = None) -> Dict[str, dict]:
    """The capacity table's entries dict ({'protocol@N': {...}}), or {}:
    `root`'s CAPACITY.json, the port's own copy when root is None."""
    try:
        with open(capacity_path(root)) as f:
            rec = json.load(f)
    except (OSError, ValueError):
        return {}
    return rec.get("entries", {}) if isinstance(rec, dict) else {}


class InvariantSentinel:
    """Per-run invariant watcher; see module docstring.

    `net` is the BatchedNetwork whose protocol names the message types;
    without it (or with telemetry off) the checks fall back to the
    always-available `state.dropped` capacity check.  `engine` is an
    object with `fire_violation(invariant, severity, ctx, **fields)`
    that counts and types the alerts; `recorder` alone also works
    (events only).
    """

    def __init__(self, net: Any = None, protocol: Optional[str] = None,
                 capacity_table: Optional[Dict[str, dict]] = None,
                 engine=None, recorder=None):
        self.net = net
        proto = protocol
        if proto is None and net is not None:
            proto = type(getattr(net, "protocol", net)).__name__
            # protocol classes are named BatchedPingPong etc.; the table
            # keys on the plain protocol name (pingpong@N)
            if proto.startswith("Batched"):
                proto = proto[len("Batched"):]
        self.protocol = proto
        self.capacity_table = (
            capacity_table if capacity_table is not None
            else load_capacity_table()
        )
        self.engine = engine
        self.recorder = recorder
        self._lock = threading.Lock()
        self._fired: set = set()  # invariant names already alerted
        self.violations: List[dict] = []

    # -- reporting -----------------------------------------------------

    def _alert(self, invariant: str, ctx=None, **fields) -> None:
        with self._lock:
            if invariant in self._fired:
                return
            self._fired.add(invariant)
            self.violations.append({"slo": invariant, **fields})
        if self.engine is not None:
            self.engine.fire_violation(
                invariant, severity="page", ctx=ctx,
                protocol=self.protocol, **fields,
            )
        elif self.recorder is not None:
            ids = ctx.ids() if hasattr(ctx, "ids") else {}
            self.recorder.record(
                "invariant-violation", slo=invariant, severity="page",
                protocol=self.protocol, **ids, **fields,
            )

    # -- capacity-table lookup ----------------------------------------

    def _entry(self, n_nodes: int) -> Optional[dict]:
        if not self.protocol:
            return None
        return self.capacity_table.get(
            f"{self.protocol.lower()}@{int(n_nodes)}"
        )

    # -- the per-chunk hook --------------------------------------------

    def check(self, state: Any, ctx=None, chunk: Optional[int] = None,
              members: Optional[List[dict]] = None,
              capacity: Optional[int] = None) -> List[dict]:
        """Run every invariant against a synced state.  `members` /
        `capacity` (a batch's packing) arm the per-tenant attribution
        reconciliation.  Returns the violations found this call (already
        alerted).  Never raises."""
        try:
            return self._check(state, ctx, chunk, members, capacity)
        except Exception as e:  # noqa: BLE001 — monitoring must not kill
            self._alert(
                "store-invariant", ctx, chunk=chunk,
                detail=f"sentinel error: {type(e).__name__}: {e}"[:300],
            )
            return []

    def _check(self, state: Any, ctx, chunk, members, capacity
               ) -> List[dict]:
        found: List[dict] = []

        def alert(invariant: str, **fields) -> None:
            found.append({"slo": invariant, **fields})
            self._alert(invariant, ctx, chunk=chunk, **fields)

        n_nodes = int(state.done_at.shape[-1])
        entry = self._entry(n_nodes)
        mtypes = self._mtype_names()

        # always-available tier: the store-overflow drop counter
        dropped_rows = host(state.dropped).reshape(-1)
        dropped_total = int(dropped_rows.sum())

        tele = getattr(state, "tele", None)
        armed = tele is not None and hasattr(tele, "sent")

        # 1. store invariant (telemetry on: sent/delivered/discarded/
        #    dropped are side-car counters)
        if armed:
            sent = self._per_mtype(tele.sent)
            delivered = self._per_mtype(tele.delivered)
            discarded = self._per_mtype(tele.discarded)
            t_dropped = self._per_mtype(tele.dropped)
            pending = int(
                host(state.msg_valid).sum() + host(state.ovf_valid).sum()
            )
            accounted = delivered + discarded + t_dropped
            if int(sent.sum()) != int(accounted.sum()) + pending:
                alert(
                    "store-invariant",
                    sent=int(sent.sum()), delivered=int(delivered.sum()),
                    discarded=int(discarded.sum()),
                    dropped=int(t_dropped.sum()), pending=pending,
                    detail="sent != delivered + discarded + dropped "
                           "+ pending",
                )
            over = np.nonzero(accounted > sent)[0]
            if over.size:
                m = int(over[0])
                alert(
                    "store-invariant", mtype=self._mtype(mtypes, m),
                    sent=int(sent[m]), accounted=int(accounted[m]),
                    detail="per-mtype delivered+discarded+dropped "
                           "exceeds sent",
                )

        # 2. the table's dropped == 0 promise
        if entry is not None and entry.get("dropped") == 0 and dropped_total:
            replica = int(dropped_rows.argmax())
            fields = {
                "dropped": dropped_total, "replica": replica,
                "n_nodes": n_nodes,
                "detail": "store dropped messages under a CAPACITY.json "
                          "sizing that promises dropped == 0",
            }
            if armed:
                per_m = self._per_mtype(tele.dropped)
                fields["mtype"] = self._mtype(mtypes, int(per_m.argmax()))
            alert("capacity-dropped", **fields)

        # 3. HWM headroom vs the sized capacities
        if entry is not None and armed:
            sized = entry.get("sized", {})
            for hwm_key, cap_key, leaf in (
                ("wheel_fill_hwm", "wheel_slots", "wheel_fill_hwm"),
                ("overflow_hwm", "overflow_capacity", "ovf_hwm"),
            ):
                cap = sized.get(cap_key)
                arr = getattr(tele, leaf, None)
                if cap is None or arr is None:
                    continue
                hwm = int(host(arr).max())
                if hwm >= int(cap):
                    alert(
                        "hwm-headroom", hwm=hwm, sized=int(cap),
                        which=hwm_key, n_nodes=n_nodes,
                        detail=f"{hwm_key} reached the sized "
                               f"{cap_key} — zero headroom left",
                    )

        # 4. attribution reconciliation: with the batch's members,
        #    per-tenant ticks must sum exactly to ticks_live; without,
        #    the per-replica rows must sum to the loop total
        if armed and members:
            att = batch_attribution(
                self.net, state, members, capacity or len(members)
            )
            ticks_live = att["batch"]["ticks_live"]
            tenant_sum = sum(
                t["ticks"] or 0 for t in att["tenants"].values()
            )
            if ticks_live is not None and tenant_sum != ticks_live:
                alert(
                    "attribution-reconcile",
                    tenant_ticks=tenant_sum, ticks_live=ticks_live,
                    tenants=sorted(att["tenants"]),
                    detail="per-tenant ticks do not sum to ticks_live",
                )
        elif armed and hasattr(tele, "ticks"):
            rows = replica_rows(self.net, state)
            per_replica = rows["ticks"]
            total = int(host(tele.ticks).sum())
            if per_replica is not None and int(per_replica.sum()) != total:
                alert(
                    "attribution-reconcile",
                    per_replica_sum=int(per_replica.sum()), total=total,
                    detail="per-replica tick rows do not sum to the "
                           "loop total",
                )

        return found

    # -- helpers -------------------------------------------------------

    @staticmethod
    def _per_mtype(a) -> np.ndarray:
        """Sum a per-mtype telemetry leaf over every replica axis,
        keeping the trailing [T] mtype axis."""
        a = host(a)
        if a.ndim == 0:
            return a.reshape(1)
        return a.reshape(-1, a.shape[-1]).sum(axis=0)

    def _mtype_names(self) -> Optional[List[str]]:
        proto = getattr(self.net, "protocol", None)
        names = getattr(proto, "MSG_TYPES", None)
        return list(names) if names else None

    @staticmethod
    def _mtype(names: Optional[List[str]], idx: int) -> str:
        if names and 0 <= idx < len(names):
            return names[idx]
        return f"mtype{idx}"
