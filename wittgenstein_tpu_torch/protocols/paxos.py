"""Paxos parameters and node population (reference: protocols/Paxos.java).

The host part of the JAX package's protocols/paxos.py, as the port's own
copy: `PaxosParameters`, `MAX_VAL`, and the population that `Paxos.init`
builds — the acceptors first, then the proposers, each drawing its
position from one JavaRandom(0) as Node draws it, a proposer then its
`valueProposed = rd.nextInt(MAX_VAL)` (Paxos.java:278-285).  Each
proposer starts its first proposal inside init, before the next proposer
is built, and that send moves the generator: the acceptor list's shuffle
and the multi-send's seed (Paxos.java:313-338, Network.java:341-447).
`paxos_roles` replays those draws so the next proposer's position and
value are the oracle's.  The oracle's messages and tasks are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..core.node import Node
from ..core.registries import registry_node_builders
from ..utils.javarand import JavaRandom

MAX_VAL = 1000


@dataclasses.dataclass
class PaxosParameters:
    acceptor_count: int = 3
    proposer_count: int = 3
    timeout: int = 1000
    node_builder: Optional[str] = None
    latency: Optional[str] = None


def paxos_roles(params: PaxosParameters):
    """The oracle's node population in id order and its role columns:
    returns (nodes, roles) with roles = {is_acc, is_prop (bool[N]), rank,
    value_proposed (int32[N], 0 for an acceptor), acc_ids, prop_ids}, as
    the JAX package's make_paxos builds them."""
    nb = registry_node_builders.get_by_name(params.node_builder)
    rd = JavaRandom(0)  # the oracle network's generator
    nodes: List[Node] = [Node(rd, nb) for _ in range(params.acceptor_count)]
    n = params.acceptor_count + params.proposer_count
    rank = np.zeros(n, np.int32)
    value = np.zeros(n, np.int32)
    for i in range(params.proposer_count):
        nd = Node(rd, nb)
        nodes.append(nd)
        rank[nd.node_id] = i
        value[nd.node_id] = rd.next_int(MAX_VAL)
        # start_next_proposal's send to the shuffled acceptors
        rd.shuffle(list(range(params.acceptor_count)))
        rd.next_int()
    is_acc = np.arange(n) < params.acceptor_count
    ids = np.arange(n, dtype=np.int32)
    roles = {
        "is_acc": is_acc,
        "is_prop": ~is_acc,
        "rank": rank,
        "value_proposed": value,
        "acc_ids": ids[is_acc],
        "prop_ids": ids[~is_acc],
    }
    return nodes, roles
