"""P2PHandel parameters and population (reference: protocols/P2PHandel.java).

A copy of the JAX package's `P2PHandelParameters` and `SendSigsStrategy`,
and `p2phandel_population`, which replays P2PHandel.init
(P2PHandel.java:482-509) on the host: the relay draw, node construction
and the P2P graph, from the same JavaRandom(0) stream as the oracle
network's.  The oracle DES is not ported.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np

from ..core.registries import registry_node_builders
from ..oracle.p2p import P2PNetwork, P2PNode, build_adjacency


class SendSigsStrategy(enum.Enum):
    all = "all"  # send all signatures, ignore peer state
    dif = "dif"  # send just the diff
    cmp_all = "cmp_all"  # send all, compressed
    cmp_diff = "cmp_diff"  # compressed; diff if it compresses smaller


@dataclasses.dataclass
class P2PHandelParameters:
    signing_node_count: int = 100
    relaying_node_count: int = 20
    threshold: int = 99
    connection_count: int = 40
    pairing_time: int = 100
    sigs_send_period: int = 1000
    double_aggregate_strategy: bool = True
    send_sigs_strategy: str = "dif"
    send_state: bool = False
    node_builder_name: Optional[str] = None
    network_latency_name: Optional[str] = None

    @property
    def strategy(self) -> SendSigsStrategy:
        s = self.send_sigs_strategy
        return s if isinstance(s, SendSigsStrategy) else SendSigsStrategy(s)


def p2phandel_population(params: P2PHandelParameters):
    """P2PHandel.init's host part: the just-relay set drawn first, then
    the nodes (one position draw each), then setPeers — all from the
    network's JavaRandom(0).  Returns (nodes, adjacency [N, max_degree]
    int32 with -1 = no peer, just_relay bool[N])."""
    n = params.signing_node_count + params.relaying_node_count
    net = P2PNetwork(params.connection_count, False)
    nb = registry_node_builders.get_by_name(params.node_builder_name)
    relay = set()
    while len(relay) < params.relaying_node_count:
        relay.add(net.rd.next_int(n))
    for _ in range(n):
        net.add_node(P2PNode(net.rd, nb))
    net.set_peers()
    just_relay = np.array([i in relay for i in range(n)])
    return net.all_nodes, build_adjacency(net.all_nodes), just_relay
