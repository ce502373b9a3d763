"""SanFerminCappos parameters and population (reference:
protocols/SanFerminCappos.java).

A copy of the JAX package's `SanFerminParameters`.  The nodes
SanFerminCappos.init builds (SanFerminCappos.java:120-134) are N
constructions, one position draw each, from the oracle network's
JavaRandom(0) — SanFerminSignature's population, so the batched protocol
takes it from `sanfermin.sanfermin_population`.  init then builds a
SanFerminHelper per node on the same generator; its draws (the shuffles
of pickNextNodes) come after every node is built and change no node
column, and the batched protocol enumerates candidates by XOR blocks
instead.  The oracle DES is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class SanFerminParameters:
    node_count: int = 32768 // 16
    threshold: int = 32768 // 32
    pairing_time: int = 2
    signature_size: int = 48
    timeout: int = 150
    candidate_count: int = 50
    node_builder_name: Optional[str] = None
    network_latency_name: Optional[str] = None
    verbose: bool = False

