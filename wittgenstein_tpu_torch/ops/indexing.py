"""Per-replica gathers and scatters over the explicit replica axis.

The JAX package writes every kernel for one replica and `vmap`s it, so
its indexing is `col[idx]` over a node axis.  The port carries the
replica axis R in front of every state tensor, so the same reads and
writes go through `torch.gather`/`scatter` along dim 1 with per-replica
index rows.
"""

from __future__ import annotations

import torch


def take(col: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`col[r, idx[r, ...]]` for col [R, N] and idx [R, ...] -> idx.shape."""
    r = col.shape[0]
    flat = idx.reshape(r, -1).to(torch.int64)
    return torch.gather(col, 1, flat).reshape(idx.shape)


def add_at(col: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Functional `col.at[idx].add(vals)` per replica: col [R, N], idx and
    vals [R, M].  Integer adds commute, so the result does not depend on
    the order the scatter applies duplicates in."""
    return col.scatter_add(1, idx.to(torch.int64), vals.to(col.dtype))


def set_rows(a: torch.Tensor, flat_idx: torch.Tensor, vals: torch.Tensor,
             keep: torch.Tensor) -> torch.Tensor:
    """Functional `a.at[...].set(vals, mode="drop")` over a flattened view.

    flat_idx [M, w] are positions in `a.reshape(-1)`, vals [M, w] the words
    to write, keep [M] the rows that write; the kept rows' positions must
    be distinct (which the JAX code guarantees where it relies on the
    result).  Dropped rows are routed to a trash block past the end and
    sliced off, the torch stand-in for JAX's out-of-bounds drop."""
    n = a.numel()
    w = flat_idx.shape[-1]
    trash = n + torch.arange(w, device=a.device, dtype=torch.int64)
    idx = torch.where(keep[:, None], flat_idx.to(torch.int64), trash)
    ext = torch.cat([a.reshape(-1), a.new_zeros(w)])
    ext.index_put_((idx.reshape(-1),), vals.reshape(-1).to(a.dtype))
    return ext[:n].view(a.shape)


def live_rows(masks):
    """Compact the live rows of [R, K] masks: for each mask, None if no
    replica has a live row, else (idx [R, M], live [R, M]) — each
    replica's live row indices first, in order, padded with masked rows
    (index 0), M the most live rows of any replica.  One device read for
    all the masks."""
    if not masks:
        return []
    counts = [m.sum(-1) for m in masks]
    sizes = torch.stack([c.amax() for c in counts]).tolist()
    out = []
    for m, c, m2 in zip(masks, counts, sizes):
        if m2 == 0:
            out.append(None)
            continue
        r, k = m.shape
        pos = m.to(torch.int64).cumsum(-1) - 1
        idx = torch.zeros((r, m2 + 1), dtype=torch.int64, device=m.device)
        idx.scatter_(1, torch.where(m, pos, m2),
                     torch.arange(k, device=m.device).expand(r, k))
        live = torch.arange(m2, device=m.device) < c[:, None]
        out.append((idx[:, :m2], live))
    return out
