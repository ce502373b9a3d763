"""Per-tenant attribution over the packed replica axis.

A batch scheduler packs one job per replica row (padding rows fill the
family's fixed capacity), so every per-replica telemetry or fault
counter is per-job attribution: this module slices a final batched
state along axis 0 and regroups rows by tenant.

Device-time share: the batched engine runs replicas in lockstep (one
device tick executes every row), so a tenant's share of device time is
its share of executed row-ticks.  Padding rows tick too; their cost is
reported separately (`batch.ticks_padding`), so per-tenant ticks always
sum to `batch.ticks_live` and live shares sum to 1.

Everything here reads copies of a final state's leaves on the host
(only the leaves it counts); nothing feeds back into the simulation.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch


def host(leaf) -> np.ndarray:
    """A leaf (a tensor on any device, or an array) as a numpy array."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _per_replica(leaf) -> Optional[np.ndarray]:
    """Sum a batched leaf over everything but the leading replica axis.
    None for absent side-cars (telemetry or faults off)."""
    if leaf is None:
        return None
    a = host(leaf)
    if a.ndim == 0:  # unbatched scalar: a single replica
        return a.reshape(1)
    return a.reshape(a.shape[0], -1).sum(axis=1)


def replica_rows(net, state) -> dict:
    """Per-replica counter rows from a (possibly batched) final state.

    Returns arrays of length R (the replica axis):
      ticks / jumps          engine loop counters (telemetry on only)
      sent / delivered       store counters (telemetry on only)
      dropped                store-overflow drops (always)
      fault_dropped/_delayed fault-lane counters (fault side-car only)
      done_nodes             nodes finished per row (always)
    """
    tele = getattr(state, "tele", None)
    armed = tele is not None and hasattr(tele, "ticks")
    done_at = host(state.done_at)
    if done_at.ndim == 1:
        done_at = done_at[None, :]
    faults = getattr(state, "faults", None)
    have_faults = faults is not None and hasattr(faults, "dropped_by_fault")
    return {
        "replicas": int(done_at.shape[0]),
        "ticks": _per_replica(tele.ticks) if armed else None,
        "jumps": _per_replica(tele.jumps) if armed else None,
        "sent": _per_replica(tele.sent) if armed else None,
        "delivered": _per_replica(tele.delivered) if armed else None,
        "dropped": _per_replica(state.dropped),
        "fault_dropped": (
            _per_replica(faults.dropped_by_fault) if have_faults else None
        ),
        "fault_delayed": (
            _per_replica(faults.delayed_by_fault) if have_faults else None
        ),
        "done_nodes": (done_at > 0).sum(axis=1),
    }


def _row_val(arr, i) -> Optional[int]:
    return int(arr[i]) if arr is not None else None


def batch_attribution(net, state, members: List[dict], capacity: int) -> dict:
    """Attribute a packed batch's counters to its member jobs/tenants.

    `members`: one dict per live row, in replica-row order:
    `{"job_id", "run_id", "tenant"}`.  Rows `len(members)..capacity` are
    padding.

    Returns::

        {"batch":   {replicas, live_rows, padding_rows,
                     ticks_live, ticks_padding, ticks_total, dropped, ...},
         "jobs":    {job_id: {run_id, tenant, replica, ticks,
                              device_time_share, dropped, fault_dropped,
                              fault_delayed, done_nodes}},
         "tenants": {tenant: {jobs, replicas:[...], ticks,
                              device_time_share, dropped, ...}}}

    Per-tenant `ticks` sum to `batch.ticks_live` exactly;
    `device_time_share` is ticks / ticks_live (None with telemetry off).
    """
    rows = replica_rows(net, state)
    n_live = len(members)
    n_rows = rows["replicas"]
    ticks = rows["ticks"]

    def live_sum(arr):
        return int(arr[:n_live].sum()) if arr is not None else None

    ticks_live = live_sum(ticks)
    ticks_total = int(ticks.sum()) if ticks is not None else None

    batch = {
        "replicas": n_rows,
        "capacity": int(capacity),
        "live_rows": n_live,
        "padding_rows": n_rows - n_live,
        "ticks_live": ticks_live,
        "ticks_padding": (
            ticks_total - ticks_live if ticks_total is not None else None
        ),
        "ticks_total": ticks_total,
        "dropped": live_sum(rows["dropped"]),
        "fault_dropped": live_sum(rows["fault_dropped"]),
        "fault_delayed": live_sum(rows["fault_delayed"]),
        "done_nodes": live_sum(rows["done_nodes"]),
    }

    def share(i) -> Optional[float]:
        if ticks is None or not ticks_live:
            return None
        return float(ticks[i]) / float(ticks_live)

    jobs = {}
    tenants: dict = {}
    for i, m in enumerate(members):
        tenant = m.get("tenant") or "default"
        job = {
            "run_id": m.get("run_id"),
            "tenant": tenant,
            "replica": i,
            "ticks": _row_val(ticks, i),
            "device_time_share": share(i),
            "dropped": _row_val(rows["dropped"], i),
            "fault_dropped": _row_val(rows["fault_dropped"], i),
            "fault_delayed": _row_val(rows["fault_delayed"], i),
            "done_nodes": _row_val(rows["done_nodes"], i),
        }
        jobs[m["job_id"]] = job
        t = tenants.setdefault(
            tenant,
            {
                "jobs": 0,
                "replicas": [],
                "ticks": 0 if ticks is not None else None,
                "device_time_share": 0.0 if ticks is not None else None,
                "dropped": 0,
                "fault_dropped": 0 if rows["fault_dropped"] is not None else None,
                "fault_delayed": 0 if rows["fault_delayed"] is not None else None,
                "done_nodes": 0,
            },
        )
        t["jobs"] += 1
        t["replicas"].append(i)
        for key in ("ticks", "dropped", "fault_dropped", "fault_delayed", "done_nodes"):
            if job[key] is not None and t[key] is not None:
                t[key] += job[key]
        if job["device_time_share"] is not None and t["device_time_share"] is not None:
            t["device_time_share"] += job["device_time_share"]

    return {"batch": batch, "jobs": jobs, "tenants": tenants}
