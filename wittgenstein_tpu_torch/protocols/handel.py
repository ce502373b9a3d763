"""Handel parameters (reference: protocols/Handel.java; arXiv:1906.05132).

A copy of the JAX package's `HandelParameters` with its validation; the
shared aggregation-parameter normalization and the oracle network's
bad-node draw live in `_aggregation.py` and are re-exported here under
their names, so `make_handel` and its callers build the same population
from the same JavaRandom stream.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ._aggregation import choose_bad_nodes, normalize_agg_params  # noqa: F401


@dataclasses.dataclass
class HandelParameters:
    node_count: int = 32768 // 1024
    threshold: float = -1
    pairing_time: int = 3
    level_wait_time: int = 50
    extra_cycle: int = 10
    dissemination_period_ms: int = 10
    fast_path: int = 10
    nodes_down: int = 0
    node_builder_name: Optional[str] = None
    network_latency_name: Optional[str] = None
    desynchronized_start: int = 0
    byzantine_suicide: bool = False
    hidden_byzantine: bool = False
    bad_nodes: Optional[int] = None  # bitset of forced-down nodes
    window_initial: int = 16
    window_minimum: int = 1
    window_maximum: int = 128
    window_increase_factor: float = 2.0
    window_decrease_factor: float = 4.0
    # batched-engine knobs (no oracle effect): in-flight channel slots and
    # verification-candidate slots per (receiver, level); None = the
    # engine defaults (BatchedHandel.CHANNEL_DEPTH / CAND_SLOTS)
    channel_depth: Optional[int] = None
    cand_slots: Optional[int] = None

    def __post_init__(self):
        normalize_agg_params(self)
        if self.node_count.bit_count() != 1:
            raise ValueError("We support only power of two nodes in this simulation")
        if self.byzantine_suicide and self.hidden_byzantine:
            raise ValueError("Only one attack at a time")


def flagship_params(node_ct: int) -> HandelParameters:
    """The BASELINE.json flagship Handel configuration at `node_ct`
    (the JAX package's profiling.ablation.flagship_params)."""
    return HandelParameters(
        node_count=node_ct,
        threshold=int(node_ct * 0.99),
        pairing_time=3,
        level_wait_time=50,
        extra_cycle=10,
        dissemination_period_ms=10,
        fast_path=10,
        nodes_down=0,
    )
