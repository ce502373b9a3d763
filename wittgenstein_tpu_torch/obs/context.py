"""Trace context: the correlated identity of a run.

A `TraceContext` is minted once per unit of admitted work and threaded
through everything that records: flight-recorder events, checkpoint
manifests (`engine/checkpoint.manifest_trace`), run records.  Every record
that carries `run_id` can be joined to the others.

- `run_id`    one durable run of work; a resumed run adopts the stored id
              instead of minting a new one.
- `job_id`    the serving layer's job, when the run came through one.
- `tenant_id` the submitting tenant.
- `chunk_seq` the chunk index inside a chunked run, set per chunk event.

The context is frozen (derive narrowed copies with `child()`) and pure
host metadata: nothing here touches simulation state.
"""

from __future__ import annotations

import binascii
import dataclasses
import os
import time
from typing import Optional


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """Immutable bundle of correlation ids carried by every obs record."""

    run_id: str
    job_id: Optional[str] = None
    tenant_id: Optional[str] = None
    chunk_seq: Optional[int] = None

    def child(self, **overrides) -> "TraceContext":
        """A copy with some ids narrowed (e.g. `ctx.child(chunk_seq=3)`)."""
        return dataclasses.replace(self, **overrides)

    def ids(self) -> dict:
        """The ids that are set, as a flat dict: the join keys of a record."""
        out = {"run_id": self.run_id}
        if self.job_id is not None:
            out["job_id"] = self.job_id
        if self.tenant_id is not None:
            out["tenant_id"] = self.tenant_id
        if self.chunk_seq is not None:
            out["chunk_seq"] = self.chunk_seq
        return out


def new_run_id(prefix: str = "run") -> str:
    """A fresh run id, `prefix-SSSSSSSS-RRRRRRRR`: unix seconds and 4
    random bytes, sortable by mint time and unique without coordination."""
    stamp = format(int(time.time()) & 0xFFFFFFFF, "08x")
    rand = binascii.hexlify(os.urandom(4)).decode("ascii")
    return f"{prefix}-{stamp}-{rand}"


def mint_context(
    prefix: str = "run",
    job_id: Optional[str] = None,
    tenant_id: Optional[str] = None,
) -> TraceContext:
    """A new root context; mint once per unit of work and thread it."""
    return TraceContext(run_id=new_run_id(prefix), job_id=job_id, tenant_id=tenant_id)
