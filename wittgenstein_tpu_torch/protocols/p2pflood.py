"""P2PFlood parameters and population (reference: protocols/P2PFlood.java).

A copy of the JAX package's `P2PFloodParameters`, and
`p2pflood_population`, which replays P2PFlood.init on the host from the
oracle network's JavaRandom(0): the nodes (one position draw each; the
first `dead_node_count` are down from t = 0), setPeers, then the sender
picks.  Each pick draws `next_int(node_count)`; an accepted live sender
then floods its peers through sendPeers, which moves the same generator
twice before the next pick: the shuffle of the peer list
(P2PNetwork.sendPeers) and the multi-send's seed, one `next_int()`
(Network.send).  With `msg_count` > 1 those draws decide the next
senders, so they are replayed.  The oracle DES is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core.registries import registry_node_builders
from ..oracle.p2p import P2PNetwork, P2PNode, build_adjacency


@dataclasses.dataclass
class P2PFloodParameters:
    node_count: int = 100
    dead_node_count: int = 10
    delay_before_resent: int = 50
    msg_count: int = 1
    msg_to_receive: int = 1
    peers_count: int = 10
    delay_between_sends: int = 30
    node_builder_name: Optional[str] = None
    network_latency_name: Optional[str] = None


def p2pflood_population(params: P2PFloodParameters):
    """P2PFlood.init's host part.  Returns (nodes, adjacency [N, max_degree]
    int32 with -1 = no peer, down bool[N], senders): `senders` are the
    flood origins in node-id order, as the JAX package's make_p2pflood
    lists them (flood id f starts at senders[f])."""
    p = params
    net = P2PNetwork(p.peers_count, True)
    nb = registry_node_builders.get_by_name(p.node_builder_name)
    for _ in range(p.node_count):
        net.add_node(P2PNode(net.rd, nb))
    down = np.arange(p.node_count) < p.dead_node_count
    net.set_peers()
    senders: set = set()
    while len(senders) < p.msg_count:
        node_id = net.rd.next_int(p.node_count)
        if not down[node_id] and node_id not in senders:
            senders.add(node_id)
            # sendPeers: shuffle a copy of the peer list, then one seed draw
            net.rd.shuffle(list(net.all_nodes[node_id].peers))
            net.rd.next_int()
    return net.all_nodes, build_adjacency(net.all_nodes), down, sorted(senders)
