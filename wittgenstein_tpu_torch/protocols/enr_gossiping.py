"""ENRGossiping parameters and initial population (reference:
protocols/ENRGossiping.java).

A copy of the JAX package's `ENRParameters` and `PEERS_PER_CAP`, and
`enr_population`, which replays ENRGossiping.init on the host from the
oracle network's JavaRandom(0), draw for draw:

  1. for each of the `nodes` nodes, `generate_cap` first (`next_int(C)`
     until `cap_per_node` distinct capabilities; the oracle evaluates the
     constructor's argument before the constructor), then the node's own
     position draw;
  2. setPeers in minimum mode (`total_peers` links a node at least);
  3. `_select_changing_nodes`: int(total_peers * changing_nodes) ids,
     each `next_int(total_peers)` — the reference multiplies
     `total_peers`, not `nodes`, and allows repeats
     (ENRGossiping.java:142-148);
  4. one start draw `next_int(time_to_change) + 1` per changing node (the
     periodic task it registers draws nothing);
  5. the "Capabilities are not well distributed" check.

Capabilities are ints here (the oracle names them "cap_<i>").  The DES
parts stay out, as for every other oracle the port replays: the tasks,
`on_flood`'s object form, the score and BFS methods, and the
`cap_search` scenario.  The batched protocol (`enr_batched.make_enr`)
continues the same generator for its join, exit and broadcast schedule.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Set

from ..core.registries import registry_node_builders
from ..oracle.p2p import P2PNetwork, P2PNode

PEERS_PER_CAP = 3


def _minutes_to_ms(mins: int) -> int:
    return mins * 1000 * 60


@dataclasses.dataclass
class ENRParameters:
    time_to_change: int = _minutes_to_ms(10000)
    cap_gossip_time: int = _minutes_to_ms(5)
    discard_time: int = 100
    time_to_leave: int = _minutes_to_ms(60)
    total_peers: int = 5
    nodes: int = 50
    changing_nodes: float = 10
    max_peers: int = 50
    number_of_different_capabilities: int = 5
    cap_per_node: int = 5
    node_builder_name: Optional[str] = None
    network_latency_name: Optional[str] = None


class ETHNode(P2PNode):
    __slots__ = ("capabilities",)

    def __init__(self, net: P2PNetwork, nb, capabilities: Set[int]):
        super().__init__(net.rd, nb)
        self.capabilities = capabilities


def generate_cap(params: ENRParameters, net: P2PNetwork) -> Set[int]:
    """cap_per_node distinct capabilities, drawn until the set is full."""
    caps: Set[int] = set()
    while len(caps) < params.cap_per_node:
        caps.add(net.rd.next_int(params.number_of_different_capabilities))
    return caps


def enr_population(params: ENRParameters):
    """ENRGossiping.init's host part.  Returns (net, changed): the P2P
    network (its nodes with capabilities and peers, and its generator,
    positioned after init's draws) and the changing nodes' ids in draw
    order, repeats included."""
    p = params
    net = P2PNetwork(p.total_peers, True)
    nb = registry_node_builders.get_by_name(p.node_builder_name)
    for _ in range(p.nodes):
        caps = generate_cap(p, net)
        net.add_node(ETHNode(net, nb, caps))
    net.set_peers()

    changed: List[int] = [
        net.rd.next_int(p.total_peers) for _ in range(int(p.total_peers * p.changing_nodes))
    ]
    for _ in changed:
        net.rd.next_int(p.time_to_change)  # the change task's start draw
    counts: dict = {}
    for n in net.all_nodes:
        for c in n.capabilities:
            counts[c] = counts.get(c, 0) + 1
    if any(v == 1 for v in counts.values()):
        raise RuntimeError("Capabilities are not well distributed")
    return net, changed
