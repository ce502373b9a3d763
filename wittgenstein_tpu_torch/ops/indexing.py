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


# the cells past the end that add_masked spreads its unmasked rows over
TRASH_CELLS = 1024


def add_masked(cols, idx: torch.Tensor, vals, mask: torch.Tensor) -> tuple:
    """`add_at(col, idx, where(mask, v, 0))` for each col [R, N] of `cols`
    with its v [R, M] of `vals`, all through one routed index: the
    unmasked rows add into TRASH_CELLS cells past the end, spread by
    position, instead of adding 0 at their own index.  A sparse store's
    view is mostly empty slots whose index is the same stale node, and on
    the card atomic adds to one address serialize.  Integer adds: the
    results are the same."""
    r, n = cols[0].shape
    spread = n + torch.arange(idx.shape[1], device=idx.device) % TRASH_CELLS
    idx = torch.where(mask, idx.to(torch.int64), spread)
    return tuple(
        torch.cat([c, c.new_zeros(r, TRASH_CELLS)], 1).scatter_add(1, idx, v.to(c.dtype))[:, :n]
        for c, v in zip(cols, vals))


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


def lowest_slot(cell: torch.Tensor, mask: torch.Tensor, n_cells: int) -> torch.Tensor:
    """The JAX package's lowest-slot winner table, `winner.at[cell].min(slot)`:
    for each of `n_cells` cells, the lowest position of a masked row of
    [R, M] that holds it, M where none does ([R, n_cells] int64).  The
    unmasked rows go to a trash cell."""
    r, m = mask.shape
    slot = torch.arange(m, device=mask.device).expand(r, m)
    win = torch.full((r, n_cells + 1), m, dtype=torch.int64, device=mask.device)
    win = win.scatter_reduce(1, torch.where(mask, cell.to(torch.int64), n_cells), slot, "amin")
    return win[:, :n_cells]


def take_won(col: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """The winning rows' values of col [R, M] at a `lowest_slot` table:
    0 for a cell without a winner (its entry M reads a pad column)."""
    return torch.gather(torch.cat([col, col.new_zeros(col.shape[0], 1)], 1), 1, win)


def first_in_cell(cell: torch.Tensor, mask: torch.Tensor, n_cells: int) -> torch.Tensor:
    """Which masked rows of [R, M] win their cell's race (`lowest_slot`):
    JAX's `winner[cell] == slot`."""
    m = mask.shape[1]
    win = torch.gather(lowest_slot(cell, mask, n_cells), 1, cell.to(torch.int64).clamp(0, n_cells - 1))
    return mask & (win == torch.arange(m, device=mask.device))


def put_cells(col: torch.Tensor, cell: torch.Tensor, vals, mask: torch.Tensor,
              reduce=None) -> torch.Tensor:
    """Functional drop-mode scatter into col [R, ...] over its flattened
    cells: the masked rows of cell [R, M] write `vals` (a tensor [R, M] or
    a scalar; `reduce` "amax" keeps the larger), the others go to a trash
    cell."""
    r = col.shape[0]
    flat = col.reshape(r, -1)
    n = flat.shape[1]
    idx = torch.where(mask, cell.to(torch.int64), n)
    if not isinstance(vals, torch.Tensor):
        vals = torch.full(idx.shape, vals, dtype=col.dtype, device=col.device)
    ext = torch.cat([flat, flat.new_zeros(r, 1)], 1)
    if reduce is None:
        ext = ext.scatter(1, idx, vals.to(col.dtype))
    else:
        ext = ext.scatter_reduce(1, idx, vals.to(col.dtype), reduce)
    return ext[:, :n].reshape(col.shape)


def delivered_rows(deliver_mask: torch.Tensor):
    """(idx, live) of the delivered rows of a view, each replica's in view
    order (`live_rows`; one device read); [R, 0] when no
    replica has one."""
    (rows,) = live_rows([deliver_mask])
    if rows is not None:
        return rows
    r = deliver_mask.shape[0]
    dev = deliver_mask.device
    return (torch.zeros((r, 0), dtype=torch.int64, device=dev),
            torch.zeros((r, 0), dtype=torch.bool, device=dev))
