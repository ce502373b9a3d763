"""ETHPoW parameters (reference: protocols/ethpow/ETHPoW.java).

The port's own copy of the JAX package's `ETHPoWParameters`
(protocols/ethpow.py:29-40).  The oracle DES of the miners stays in the
JAX package; the port runs the batched re-expression
(`ethpow_batched.BatchedEthPow`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class ETHPoWParameters:
    node_builder_name: Optional[str] = None
    network_latency_name: Optional[str] = None
    number_of_miners: int = 1
    byz_class_name: Optional[str] = None
    byz_mining_ratio: float = 0

    def __post_init__(self):
        if not self.byz_class_name:
            self.byz_class_name = None
            self.byz_mining_ratio = 0
