"""P2P overlay graph builder: random graph with average-degree or
minimum-degree modes, host-side only.

Reference semantics: core P2PNetwork.java / P2PNode.java via the JAX
package's oracle/p2p.py, with the exact RNG consumption order of setPeers
(the link-creation loop, then a shuffled per-node top-up pass).  The port
keeps the graph and its draws, not the DES: `P2PNetwork` holds the nodes
(built by core.node.Node from the network's JavaRandom) and their peer
lists, and `build_adjacency` pads them into the batched protocols'
[N, max_degree] table.  P2PHandel uses it; p2pflood,
optimistic_p2p_signature and enr build the same way.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..core.node import Node, NodeBuilder
from ..utils.javarand import JavaRandom


class P2PNode(Node):
    __slots__ = ("peers",)

    def __init__(self, rd: JavaRandom, nb: NodeBuilder, byzantine: bool = False):
        super().__init__(rd, nb, byzantine)
        self.peers: List["P2PNode"] = []


class P2PNetwork:
    """The node list, its JavaRandom stream (the oracle Network's
    `new Random(0)`, Network.java:32) and the links between nodes."""

    def __init__(self, connection_count: int, minimum: bool):
        self.rd = JavaRandom(0)
        self.all_nodes: List[P2PNode] = []
        self._connection_count = connection_count
        self._minimum = minimum
        self._existing_links: set = set()

    def add_node(self, node: P2PNode) -> None:
        if node.node_id != len(self.all_nodes):
            raise RuntimeError(f"nodes must be added in id order, got {node.node_id}")
        self.all_nodes.append(node)

    def set_peers(self) -> None:
        """P2PNetwork.setPeers (P2PNetwork.java:28-57)."""
        size = len(self.all_nodes)
        if self._connection_count >= size:
            raise ValueError(
                f"Wrong configuration: #nodes={size}, connection target={self._connection_count}"
            )
        if not self._minimum:
            to_create = (size * self._connection_count) // 2
            while to_create != len(self._existing_links):
                pp1 = self.rd.next_int(size)
                pp2 = self.rd.next_int(size)
                self._create_link(pp1, pp2)

        # shuffled top-up pass so dead-node clustering doesn't bias degrees
        # (P2PNetwork.java:44-56)
        an = list(self.all_nodes)
        self.rd.shuffle(an)
        target_min = self._connection_count if self._minimum else min(3, self._connection_count)
        for n in an:
            while len(n.peers) < target_min:
                self._create_link(n.node_id, self.rd.next_int(size))

    def _create_link(self, pp1: int, pp2: int) -> None:
        if pp1 == pp2:
            return
        link = (min(pp1, pp2), max(pp1, pp2))
        if link in self._existing_links:
            return
        self._existing_links.add(link)
        p1, p2 = self.all_nodes[pp1], self.all_nodes[pp2]
        p1.peers.append(p2)
        p2.peers.append(p1)


def build_adjacency(nodes: List[P2PNode]) -> np.ndarray:
    """Pad the P2P graph into [N, max_degree] int32, -1 = no peer, each row
    in the node's peer-list order."""
    max_deg = max((len(n.peers) for n in nodes), default=0)
    adj = np.full((len(nodes), max_deg), -1, dtype=np.int32)
    for i, n in enumerate(nodes):
        for j, p in enumerate(n.peers):
            adj[i, j] = p.node_id
    return adj
