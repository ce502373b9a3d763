"""Dfinity parameters and node population (reference: protocols/Dfinity.java).

The host part of the JAX package's protocols/dfinity.py, as the port's own
copy: `DfinityParameters` with its derived counts, and the population that
`Dfinity.__init__` and `Dfinity.init` build — the observer first, then the
attesters, block producers and random-beacon nodes, each drawing its
position from one JavaRandom(0) as BlockChainNode draws it, then the
block-producer shuffle (Dfinity.java:426-450).  `dfinity_population`
returns the nodes with the role columns the batched protocol reads; the
oracle's message classes and block DAG are not ported (the batched
protocol replaces them with a block table).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..core.node import Node
from ..core.registries import registry_node_builders
from ..utils.javarand import JavaRandom


@dataclasses.dataclass
class DfinityParameters:
    block_producers_count: int = 10
    attesters_count: int = 10
    attesters_per_round: int = 10
    block_construction_time: int = 1
    attestation_construction_time: int = 1
    percentage_dead_attester: int = 0
    node_builder_name: Optional[str] = None
    network_latency_name: Optional[str] = None  # never read — reference quirk

    round_time: int = dataclasses.field(default=3000, init=False, repr=False)
    block_producers_per_round: int = dataclasses.field(default=5, init=False, repr=False)

    def __post_init__(self):
        self.block_producers_round = self.block_producers_count // self.block_producers_per_round
        self.attesters_round = self.attesters_count // self.attesters_per_round
        # simplification: the beacon committee has the attesters' size
        self.random_beacon_count = self.attesters_per_round
        self.majority = (self.attesters_per_round // 2) + 1


def dfinity_population(params: DfinityParameters):
    """The oracle's node population in id order and its role columns:
    returns (nodes, roles) with roles = {is_att, is_bp, is_bcn (bool[N]),
    my_round, bp_local (int32[N], -1 for a non-producer), att_ids, bp_ids,
    bcn_ids (int32, in id order)}."""
    nb = registry_node_builders.get_by_name(params.node_builder_name)
    rd = JavaRandom(0)  # the oracle network's generator
    nodes: List[Node] = [Node(rd, nb)]  # the observer, node 0
    kinds, rounds = ["observer"], [0]
    for i in range(params.attesters_count):
        nodes.append(Node(rd, nb))
        kinds.append("att")
        rounds.append(i % params.attesters_round)
    bps = []
    for i in range(params.block_producers_count):
        bps.append(Node(rd, nb))
        kinds.append("bp")
        rounds.append(i % params.block_producers_round)
    nodes += bps
    for _ in range(params.random_beacon_count):
        nodes.append(Node(rd, nb))
        kinds.append("bcn")
        rounds.append(0)
    # the reference shuffles its producer list (Dfinity.java:446); ids and
    # roles keep id order, so only the generator's state moves
    rd.shuffle(bps)

    kinds = np.array(kinds)
    ids = np.arange(len(nodes), dtype=np.int32)
    roles = {
        "is_att": kinds == "att",
        "is_bp": kinds == "bp",
        "is_bcn": kinds == "bcn",
        "my_round": np.array(rounds, dtype=np.int32),
        "bp_local": np.full(len(nodes), -1, dtype=np.int32),
        "att_ids": ids[kinds == "att"],
        "bp_ids": ids[kinds == "bp"],
        "bcn_ids": ids[kinds == "bcn"],
    }
    roles["bp_local"][roles["bp_ids"]] = np.arange(len(roles["bp_ids"]), dtype=np.int32)
    return nodes, roles
