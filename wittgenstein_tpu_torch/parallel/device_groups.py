"""Device groups: partition the visible devices into G independent lanes.

A serving fleet runs K compatibility families; with one lane they
serialize through one worker.  A DeviceGroup is the unit of the JAX
package's partition (parallel/device_groups.py): a contiguous slice of
the devices, so each scheduler lane places its batches on its own
devices and up to G families execute at once ("wave packing").

The port's groups hold one device each: `place` commits every leaf of a
state to the group's device.  A group of more than one device, or
`node_parallel > 1`, splits one batch or one simulation's nodes across
devices, which waits for the multi-device slice (ROADMAP Queue A 16:
mesh2d, node_shard): constructing one raises, and so do `mesh`,
`layout` and `sharding`.  `make_device_groups` keeps the JAX package's
checks and messages; its default device list is every visible CUDA
device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from ..engine.core import SimState, map_state
from ..interop import state_from_numpy

_MULTI_ITEM = "the multi-device slice (ROADMAP Queue A 16: mesh2d, node_shard)"


@dataclasses.dataclass(frozen=True)
class DeviceGroup:
    """One lane's slice of the machine: index + devices."""

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
        if len(self.devices) > 1 or self.node_parallel > 1:
            raise NotImplementedError(
                f"a device group of {len(self.devices)} devices with "
                f"node_parallel={self.node_parallel} needs {_MULTI_ITEM}"
            )
        object.__setattr__(self, "devices", tuple(torch.device(d) for d in self.devices))

    @property
    def replica_parallel(self) -> int:
        return len(self.devices) // self.node_parallel

    @property
    def mesh(self):
        raise NotImplementedError(f"a group's mesh needs {_MULTI_ITEM}")

    def layout(self):
        raise NotImplementedError(f"a group's layout needs {_MULTI_ITEM}")

    def sharding(self):
        raise NotImplementedError(f"a group's sharding needs {_MULTI_ITEM}")

    def place(self, states, net=None):
        """Commit a stacked state (leading replica axis) to this group's
        device: a SimState, or the host tree of numpy leaves in the JAX
        package's layout that the Supervisor hands a placement.  `net`
        is accepted for the JAX package's signature: a one-device group
        has no node axis to classify columns for."""
        del net
        dev = self.devices[0]
        if isinstance(states, SimState):
            return map_state(lambda a: a.to(dev), states)
        return state_from_numpy(states, dev)

    def label(self) -> str:
        return f"group{self.index}[{len(self.devices)}dev]"


def visible_devices() -> list:
    """Every visible CUDA device, in index order."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_device_groups(
    n_groups: int,
    devices: Optional[Sequence] = None,
    node_parallel: int = 1,
) -> List[DeviceGroup]:
    """Partition ``devices`` (default: every visible CUDA device) into
    ``n_groups`` contiguous equal slices.  Group count must divide the
    device count and node_parallel must divide the per-group size — an
    uneven fleet would give lanes different program geometries and
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
