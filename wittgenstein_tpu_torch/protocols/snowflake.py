"""Snowflake parameters (reference: protocols/Snowflake.java).

A copy of the JAX package's `SnowflakeParameters`: Slush plus a
confidence counter B — a node accepts once it has seen B consecutive
same-color majorities (the counter reset on a flip, Snowflake.java:
170-188).  The population is `_avalanche.avalanche_population`; the
oracle DES is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class SnowflakeParameters:
    nodes_av: int = 100
    m: int = 4
    k: int = 7
    a: float = 4.0
    b: int = 7
    node_builder_name: Optional[str] = None
    network_latency_name: Optional[str] = None

    @property
    def ak(self) -> float:
        return self.a * self.k
