"""SanFerminSignature parameters and population (reference:
protocols/SanFerminSignature.java, binomial-tree pairwise BLS
aggregation).

A copy of the JAX package's `SanFerminSignatureParameters`, and
`sanfermin_population`, which replays the node construction of the
SanFerminSignature constructor (SanFerminSignature.java:112-130) on the
host from the oracle network's JavaRandom(0).  The oracle DES, its
messages and its SanFerminHelper candidate trees are not ported: the
batched protocol enumerates candidates by XOR blocks instead.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..core.node import Node
from ..core.registries import registry_node_builders
from ..utils.javarand import JavaRandom
from ..utils.more_math import log2


@dataclasses.dataclass
class SanFerminSignatureParameters:
    node_count: int = 32768 // 32
    threshold: int = 32768 // 32
    pairing_time: int = 2
    signature_size: int = 48
    reply_timeout: int = 300
    candidate_count: int = 1
    shuffled_lists: bool = False
    node_builder_name: Optional[str] = None
    network_latency_name: Optional[str] = None
    verbose: bool = False

    @property
    def power_of_two(self) -> int:
        return log2(self.node_count)


def sanfermin_population(params: SanFerminSignatureParameters) -> List[Node]:
    """The oracle's nodes in id order: N constructions, one position draw
    each, from the network's JavaRandom(0).  The constructor then builds a
    SanFerminHelper per node on the same generator; its draws (the
    shuffles of pickNextNodes) come later and change no node column, and
    the batched protocol reads nothing else of the generator."""
    rd = JavaRandom(0)
    nb = registry_node_builders.get_by_name(params.node_builder_name)
    return [Node(rd, nb) for _ in range(params.node_count)]
