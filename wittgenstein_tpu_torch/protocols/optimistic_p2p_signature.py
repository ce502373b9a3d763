"""OptimisticP2PSignature parameters and population (reference:
protocols/OptimisticP2PSignature.java).

A copy of the JAX package's `OptimisticP2PSignatureParameters`, and
`optimistic_population`, which replays OptimisticP2PSignature.init on
the host from the oracle network's JavaRandom(0): the nodes (one position
draw each; the self-signature task each registers draws nothing), then
setPeers.  The oracle DES is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..core.registries import registry_node_builders
from ..oracle.p2p import P2PNetwork, P2PNode, build_adjacency


@dataclasses.dataclass
class OptimisticP2PSignatureParameters:
    node_count: int = 100
    threshold: int = 99
    connection_count: int = 20
    pairing_time: int = 1
    node_builder_name: Optional[str] = None
    network_latency_name: Optional[str] = None


def optimistic_population(params: OptimisticP2PSignatureParameters):
    """OptimisticP2PSignature.init's host part.  Returns (nodes, adjacency
    [N, max_degree] int32 with -1 = no peer)."""
    net = P2PNetwork(params.connection_count, False)
    nb = registry_node_builders.get_by_name(params.node_builder_name)
    for _ in range(params.node_count):
        net.add_node(P2PNode(net.rd, nb))
    net.set_peers()
    return net.all_nodes, build_adjacency(net.all_nodes)
