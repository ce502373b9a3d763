"""HandelEth2 parameters and roles (reference: protocols/handeleth2/,
HandelEth2.java and HNode.java).

A copy of the JAX package's `HandelEth2Parameters` and period constants,
and `handeleth2_roles`, which replays HandelEth2.init
(HandelEth2.java:69-147) on the host from the oracle network's
JavaRandom(0): the bad-node draw, then per node its desynchronized-start
draw and its construction draw, then the reception ranks (one shared
list, reshuffled once per node) and the emission ranks as peers per
communication level.  It returns the roles the batched protocol bakes;
the oracle DES, its messages and periodic tasks are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core.node import Node
from ..core.registries import registry_node_builders
from ..utils.javarand import JavaRandom
from ..utils.more_math import log2
from ._aggregation import choose_bad_nodes

PERIOD_TIME = 6000
PERIOD_AGG_TIME = PERIOD_TIME * 3


@dataclasses.dataclass
class HandelEth2Parameters:
    node_count: int = 64
    pairing_time: int = 3
    level_wait_time: int = 100
    period_duration_ms: int = 50
    nodes_down: int = 0
    node_builder_name: Optional[str] = None
    network_latency_name: Optional[str] = None
    desynchronized_start: int = 0

    def __post_init__(self):
        if self.nodes_down >= self.node_count or self.nodes_down < 0:
            raise ValueError(f"nodeCount={self.node_count}")
        if self.node_count.bit_count() != 1:
            raise ValueError("We support only power of two nodes in this simulation")


def handeleth2_roles(params: HandelEth2Parameters):
    """HandelEth2.init's host part.  Returns (nodes, roles): the nodes in
    id order and the roles `make_handeleth2` bakes — reception_ranks
    [N, N] (node i's rank of node j), peers [N, lc+1, N/2] (each live
    sender's receivers per communication level in emission order, -1
    padded; a down sender's rows all -1), pairing [N] (nodePairingTime),
    delta [N] (the desynchronized start) and down bool[N]."""
    p = params
    n = p.node_count
    lc = log2(n)
    rd = JavaRandom(0)  # the oracle network's generator
    nb = registry_node_builders.get_by_name(p.node_builder_name)
    bad = choose_bad_nodes(rd, n, p.nodes_down)
    nodes, delta = [], []
    for _ in range(n):
        # HandelEth2.init draws the start before the node's own draw
        delta.append(0 if p.desynchronized_start == 0 else rd.next_int(p.desynchronized_start))
        nodes.append(Node(rd, nb))
    down = np.array([i in bad for i in range(n)])
    # HNode: nodePairingTime = (int) max(1, pairingTime * speedRatio)
    pairing = np.array(
        [max(1, int(max(1, p.pairing_time * nd.speed_ratio))) for nd in nodes], np.int32
    )

    # reception ranks (HandelEth2.java:87-95): one list, reshuffled per node
    rr = np.zeros((n, n), np.int32)
    order = list(range(n))
    for s in range(n):
        rd.shuffle(order)
        rr[s, order] = np.arange(n, dtype=np.int32)

    # emission ranks (HandelEth2.java:103-147): a sender speaks first to
    # the receivers that rank it first (ties in id order), each receiver
    # filed under its communication level — the bit length of the ids' xor
    peers = np.full((n, lc + 1, max(1, n // 2)), -1, np.int32)
    for s in range(n):
        if down[s]:
            continue
        recv = np.argsort(rr[:, s], kind="stable")
        recv = recv[recv != s]
        level = np.array([int(x).bit_length() for x in (recv ^ s)])
        for l in range(1, lc + 1):
            at = recv[level == l]
            peers[s, l, : len(at)] = at
    roles = {
        "reception_ranks": rr,
        "peers": peers,
        "pairing": pairing,
        "delta": np.array(delta, np.int32),
        "down": down,
    }
    return nodes, roles
