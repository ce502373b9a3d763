"""Slush parameters (reference: protocols/Slush.java).

A copy of the JAX package's `SlushParameters`: repeated random sampling
with an alpha threshold, M rounds per node (the color flip at `> A*K`
and the M-round counter, Slush.java:161-176).  The population is
`_avalanche.avalanche_population`; the oracle DES is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class SlushParameters:
    nodes_av: int = 100
    m: int = 4  # number of rounds; grows logarithmically with n
    k: int = 7  # sample size
    a: float = 4.0  # alpha threshold
    node_builder_name: Optional[str] = None
    network_latency_name: Optional[str] = None

    @property
    def ak(self) -> float:
        return self.k * self.a
