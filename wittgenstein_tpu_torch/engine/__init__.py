"""The batched time-stepped engine, with the replica axis carried explicitly."""

from .core import (
    BatchedNetwork,
    Emission,
    SimState,
    map_state,
    replicate_state,
    resolve_device,
    stack_states,
)
from .density import LanePlan, NarrowLeaf, lane_plan, narrowest_int
from .protocol import BatchedProtocol
from .rng import hash32, pseudo_delta, uniform_u01

__all__ = [
    "BatchedNetwork",
    "BatchedProtocol",
    "Emission",
    "LanePlan",
    "NarrowLeaf",
    "SimState",
    "hash32",
    "lane_plan",
    "map_state",
    "narrowest_int",
    "pseudo_delta",
    "replicate_state",
    "resolve_device",
    "stack_states",
    "uniform_u01",
]
