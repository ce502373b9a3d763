"""The port's collectives: the one place a tensor of the sharded path
crosses from one shard's device to another's.

A placed state (parallel.mesh2d) holds one SimState per mesh cell, each
on its cell's device, and a run on it is one program per cell: every
cell runs the engine's loop on its own thread (`spmd`), and the cells
meet only at the collectives below, as the JAX package's shard_map
bodies meet at `lax.all_to_all` and `lax.psum`.  A `Group` is the
ordered list of member devices one collective spans (a row of the
mesh for the node axis, every cell for the loop's decisions); the
devices may repeat, so a mesh of any shape runs on one card, or on a
card and the host CPU.

Three operations, each a rendezvous of every member:

- `all_to_all`: member i's tensor is [P, ...] bucketed by destination;
  member j receives the stack of every member's row j, in member order;
- `all_gather`: every member's tensor, concatenated in member order;
- `all_reduce`: sum, min, max, all or any over the members, reduced in
  member order.

Every result is a tensor of its own on the caller's device: the
operations never hand back a member's tensor, even where a move to the
same device would (`Tensor.to` returns its input then), so the
engine's rule that a run never writes into a tensor it was given holds
for exchanged buffers too.  Sums are meant for integer totals: a float
sum in member order would not be the unsharded run's reduction order,
so callers reduce integer counts and divide once.

`copy_to` is the placement's and the gather's move: a copy on the
target device that owns its storage.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Sequence

import torch

_REDUCE_OPS = ("sum", "min", "max", "all", "any")


def copy_to(t: torch.Tensor, device) -> torch.Tensor:
    """`t` on `device` in a storage of its own, dense: a slice of a larger
    tensor comes back holding only its own bytes."""
    out = t.to(torch.device(device), copy=True)
    return out if out.is_contiguous() else out.contiguous()


class Group:
    """The ordered members of a collective, one device each (devices may
    repeat).  Members are threads of one process: each collective is a
    rendezvous at a barrier, so every member must make the same
    sequence of calls."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(torch.device(d) for d in devices)
        self.size = len(self.devices)
        if self.size < 1:
            raise ValueError("a group needs at least one member")
        self._slots: List = [None] * self.size
        self._barrier = threading.Barrier(self.size) if self.size > 1 else None
        # the baton of the run this group serves (`spmd`): one cell runs
        # at a time and hands it on only while it waits here
        self.baton: Optional[threading.Lock] = None

    def _wait(self) -> None:
        if self.baton is None:
            self._barrier.wait()
            return
        self.baton.release()
        try:
            self._barrier.wait()
        finally:
            self.baton.acquire()

    def rendezvous(self, rank: int, value) -> list:
        """Every member's `value`, in member order, once all have given
        theirs; the second wait keeps a member from overwriting its slot
        before every member has read the first round."""
        if self._barrier is None:
            return [value]
        self._slots[rank] = value
        self._wait()
        values = list(self._slots)
        self._wait()
        return values

    def abort(self) -> None:
        """Release every member waiting here (a member failed)."""
        if self._barrier is not None:
            self._barrier.abort()


def all_to_all(group: Group, rank: int, tensors: Sequence[torch.Tensor]) -> list:
    """For each of `tensors` ([P, ...], row j bound for member j): the
    stack of every member's row `rank`, in member order, on this
    member's device."""
    dev = group.devices[rank]
    got = group.rendezvous(rank, tuple(tensors))
    return [torch.stack([g[k][rank].to(dev) for g in got])
            for k in range(len(tensors))]


def all_gather(group: Group, rank: int, tensors: Sequence[torch.Tensor], dim: int = 0) -> list:
    """For each of `tensors`: every member's, concatenated along `dim` in
    member order, on this member's device."""
    dev = group.devices[rank]
    got = group.rendezvous(rank, tuple(tensors))
    return [torch.cat([g[k].to(dev) for g in got], dim) for k in range(len(tensors))]


def all_reduce(group: Group, rank: int, t: torch.Tensor, op: str) -> torch.Tensor:
    """`t` reduced elementwise over the members with `op` (sum, min,
    max, all, any), in member order, on this member's device."""
    if op not in _REDUCE_OPS:
        raise ValueError(f"all_reduce op must be one of {_REDUCE_OPS}, got {op!r}")
    dev = group.devices[rank]
    stacked = torch.stack([g.to(dev) for g in group.rendezvous(rank, t)])
    if op == "sum":
        return stacked.sum(0, dtype=t.dtype)
    if op == "min":
        return stacked.amin(0)
    if op == "max":
        return stacked.amax(0)
    if op == "all":
        return stacked.all(0)
    return stacked.any(0)


def gather_to(tensors: Sequence[torch.Tensor], device, dim: int = 0) -> torch.Tensor:
    """The shards `tensors` concatenated along `dim` on `device` (a placed
    state's gather back to one device)."""
    dev = torch.device(device)
    return torch.cat([t.to(dev) for t in tensors], dim)


def spmd(tasks: Sequence[Callable], groups: Sequence[Group]) -> list:
    """Run every task on a thread of its own, one per mesh cell, and
    return their results in order.  The threads take turns: one holds
    the run's baton and computes, and hands it on only while it waits at
    a collective, so the cells' eager launches never contend for the
    interpreter (on one card they share one launch queue either way).
    The caller's autograd and inference modes hold on every thread.  A
    task that raises aborts every group, so no member waits at a
    barrier for it; the first error is raised again here."""
    inference = torch.is_inference_mode_enabled()
    grad = torch.is_grad_enabled()
    results: List = [None] * len(tasks)
    errors: List[Optional[BaseException]] = [None] * len(tasks)
    baton = threading.Lock()
    for g in groups:
        g.baton = baton

    def body(i: int) -> None:
        baton.acquire()
        try:
            with torch.inference_mode(inference), torch.set_grad_enabled(grad):
                results[i] = tasks[i]()
        except BaseException as e:  # noqa: BLE001 — raised again below
            errors[i] = e
            for g in groups:
                g.abort()
        finally:
            baton.release()

    if len(tasks) == 1:
        body(0)
    else:
        threads = [threading.Thread(target=body, args=(i,), daemon=True)
                   for i in range(len(tasks))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    # a member released by another's abort fails with BrokenBarrierError:
    # the error to report is the one that broke the barrier
    first = next((e for e in errors
                  if e is not None and not isinstance(e, threading.BrokenBarrierError)),
                 next((e for e in errors if e is not None), None))
    if first is not None:
        raise first
    return results
