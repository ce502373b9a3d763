"""Vectorized fault injection for the port's batched engine.

A host-side `FaultPlan` (crash and recovery windows, group partitions,
per-mtype drop rate, latency inflation, Byzantine silence and delay)
lowers into a `FaultState` side-car on `SimState`, heterogeneous per
replica, which the engine applies at its send and delivery choke points
when it carries a `FaultConfig` (`BatchedNetwork.with_faults`) — and
which leaves every other leaf bit-identical to a fault-free run when the
schedule is neutral.  Port of the JAX package's faults/ (its oracle
hooks drive the host DES and are not ported).
"""

from .plan import FaultPlan, FaultPlanError, fault_state_digest, lower_plans, plan_digest
from .state import (
    FAULT_STREAM,
    INT_MAX,
    FaultConfig,
    FaultState,
    deliver_suppress,
    inflate_latency,
    neutral_fault_state,
    node_crashed,
    send_suppress,
    stack_fault_states,
    window_active,
)

__all__ = [
    "FAULT_STREAM",
    "INT_MAX",
    "FaultConfig",
    "FaultPlan",
    "FaultPlanError",
    "FaultState",
    "deliver_suppress",
    "fault_state_digest",
    "inflate_latency",
    "lower_plans",
    "neutral_fault_state",
    "node_crashed",
    "plan_digest",
    "send_suppress",
    "stack_fault_states",
    "window_active",
]
