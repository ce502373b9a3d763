"""The batched time-stepped engine, with the replica axis carried explicitly."""

from .capacity import (
    CapacityEntry,
    load_capacity,
    lookup,
    size_from_hwm,
    sized_overrides,
    validate_table,
)
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
    "CapacityEntry",
    "Emission",
    "LanePlan",
    "NarrowLeaf",
    "SimState",
    "hash32",
    "lane_plan",
    "load_capacity",
    "lookup",
    "map_state",
    "narrowest_int",
    "pseudo_delta",
    "replicate_state",
    "resolve_device",
    "size_from_hwm",
    "sized_overrides",
    "stack_states",
    "uniform_u01",
    "validate_table",
]
