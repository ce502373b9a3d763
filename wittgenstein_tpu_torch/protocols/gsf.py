"""GSFSignature parameters (reference: protocols/GSFSignature.java,
"Gossiping San Fermin" BLS signature aggregation).

A copy of the JAX package's `GSFSignatureParameters` with its
normalization; the oracle DES is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ._aggregation import normalize_agg_params


@dataclasses.dataclass
class GSFSignatureParameters:
    node_count: int = 32768 // 32
    threshold: float = -1  # int count, or a (0,1] ratio; -1 = 99% default
    pairing_time: int = 3
    timeout_per_level_ms: int = 50
    period_duration_ms: int = 10
    accelerated_calls_count: int = 10
    nodes_down: float = 0  # int count or a [0,1) ratio
    node_builder_name: Optional[str] = None
    network_latency_name: Optional[str] = None

    def __post_init__(self):
        normalize_agg_params(self)
