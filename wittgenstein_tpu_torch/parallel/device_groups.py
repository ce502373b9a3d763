"""Device groups: partition the visible devices into G independent lanes.

A serving fleet runs K compatibility families; with one lane they
serialize through one worker.  A DeviceGroup is the unit of the JAX
package's partition (parallel/device_groups.py): a contiguous slice of
the devices, so each scheduler lane places its batches on its own
devices and up to G families execute at once ("wave packing").

A lane's mesh can itself be 2D: with ``node_parallel=P`` the group's
devices fold into a ``(len(devices)//P, P)`` (replicas, nodes) sub-mesh
(parallel.mesh2d), so one lane runs replica rows whose node state is
split P-ways.  With the default ``node_parallel=1`` the group is a flat
one-axis lane.

Placement, as in the JAX package: ``place`` splits the stacked state's
replica rows over the group's devices when the replica count divides the
group's replica rows (a mesh2d.PlacedState), adding the node axis when
``net`` is given and the group is 2D, and otherwise commits the whole
batch to the group's first device.  A group of one device commits the
batch to that device as a plain SimState.  The devices may repeat (one
card, or the CPU, several times).  The default device list is every
visible CUDA device (`visible_devices`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..engine.core import SimState, map_state
from ..interop import state_from_numpy
from . import exchange
from .mesh2d import DeviceMesh, MeshLayout


@dataclasses.dataclass(frozen=True)
class DeviceGroup:
    """One lane's slice of the machine: index + devices + its own
    replica-axis mesh — 2D (replicas, nodes) when ``node_parallel`` > 1."""

    index: int
    devices: tuple
    node_parallel: int = 1

    def __post_init__(self):
        if self.node_parallel < 1:
            raise ValueError(
                f"node_parallel must be >= 1, got {self.node_parallel}"
            )
        if len(self.devices) % self.node_parallel != 0:
            raise ValueError(
                f"node_parallel={self.node_parallel} must divide the "
                f"group's device count ({len(self.devices)})"
            )
        object.__setattr__(self, "devices", tuple(torch.device(d) for d in self.devices))

    @property
    def replica_parallel(self) -> int:
        return len(self.devices) // self.node_parallel

    @property
    def mesh(self) -> DeviceMesh:
        grid = np.empty(len(self.devices), dtype=object)
        grid[:] = list(self.devices)
        if self.node_parallel > 1:
            return DeviceMesh(grid.reshape(self.replica_parallel, self.node_parallel),
                              ("replicas", "nodes"))
        return DeviceMesh(grid, ("replicas",))

    def layout(self) -> MeshLayout:
        """The group's mesh as a mesh2d.MeshLayout — node axis active only
        when the group folds one in."""
        return MeshLayout(
            self.mesh,
            replica_axis="replicas",
            node_axis="nodes" if self.node_parallel > 1 else None,
        )

    def sharding(self) -> MeshLayout:
        """The replica-only layout over the group's mesh (the JAX
        package's `NamedSharding(mesh, P("replicas"))`)."""
        return MeshLayout(self.mesh, replica_axis="replicas", node_axis=None)

    def place(self, states, net=None):
        """Commit a stacked state (leading replica axis) to this group: a
        SimState, or the host tree of numpy leaves in the JAX package's
        layout that the Supervisor hands a placement.  Replica-split when
        the leading axis divides the group's replica rows, node columns
        split too with ``net`` and a 2D group, whole-batch on the first
        device otherwise (correct either way)."""
        dev = self.devices[0]
        host = not isinstance(states, SimState)
        if host:
            states = state_from_numpy(states, dev)
        n_rows = int(states.time.shape[0]) if states.time.dim() else 0
        if len(self.devices) > 1 and n_rows and n_rows % self.replica_parallel == 0:
            if net is not None and self.node_parallel > 1 \
                    and net.n_nodes % self.node_parallel == 0:
                return self.layout().place(net, states)
            return self.sharding().place(None, states)
        return states if host else map_state(lambda a: exchange.copy_to(a, dev), states)

    def label(self) -> str:
        mesh_tag = (
            f"{self.replica_parallel}x{self.node_parallel}"
            if self.node_parallel > 1
            else f"{len(self.devices)}dev"
        )
        return f"group{self.index}[{mesh_tag}]"


def visible_devices(kind: str = "cuda") -> list:
    """Every visible device of `kind`: the CUDA devices in index order,
    or the one CPU."""
    if kind == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_device_groups(
    n_groups: int,
    devices: Optional[Sequence] = None,
    node_parallel: int = 1,
) -> List[DeviceGroup]:
    """Partition ``devices`` (default: every visible CUDA device) into
    ``n_groups`` contiguous equal slices, each folded into a (replicas,
    nodes) sub-mesh when ``node_parallel`` > 1.  Group count must divide
    the device count and node_parallel must divide the per-group size —
    an uneven fleet would give lanes different program geometries and
    break the one-program-per-family contract."""
    if n_groups < 1:
        raise ValueError(f"n_groups must be >= 1, got {n_groups}")
    devs = list(devices) if devices is not None else visible_devices()
    if not devs:
        raise ValueError("no devices visible")
    if n_groups > len(devs):
        raise ValueError(
            f"n_groups={n_groups} exceeds visible devices ({len(devs)})"
        )
    if len(devs) % n_groups != 0:
        raise ValueError(
            f"n_groups={n_groups} must divide the device count "
            f"({len(devs)}) — uneven groups would compile per-lane "
            "program geometries"
        )
    per = len(devs) // n_groups
    if node_parallel < 1 or per % node_parallel != 0:
        raise ValueError(
            f"node_parallel={node_parallel} must divide the per-group "
            f"device count ({per})"
        )
    return [
        DeviceGroup(g, tuple(devs[g * per: (g + 1) * per]), node_parallel)
        for g in range(n_groups)
    ]
