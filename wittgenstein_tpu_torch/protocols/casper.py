"""CasperIMD parameters and node population (reference: protocols/CasperIMD.java).

The host part of the JAX package's protocols/casper.py, as the port's own
copy: `CasperParameters` with its attester count, the 8-second slot, and
the population that `CasperIMD.__init__` and `CasperIMD.init` build — the
observer first, then node 0's Byzantine producer, the honest producers
and the attesters, each drawing its position from one JavaRandom(0) as
BlockChainNode draws it (CasperIMD.java:472-508).  `casper_roles` returns
the nodes with the role columns the batched protocol reads.  Which
Byzantine producer class node 1 runs changes neither the draws nor the
roles.  The oracle's blocks, messages and tasks are not ported (the
batched protocol replaces them with a height-indexed block table).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..core.node import Node
from ..core.registries import registry_node_builders
from ..utils.javarand import JavaRandom

SLOT_DURATION = 8000


@dataclasses.dataclass
class CasperParameters:
    cycle_length: int = 4  # rounds per cycle; 64 in the spec
    random_on_ties: bool = True
    block_producers_count: int = 2
    attesters_per_round: int = 20
    block_construction_time: int = 1000
    attestation_construction_time: int = 1
    node_builder_name: Optional[str] = None
    network_latency_name: Optional[str] = None

    @property
    def attesters_count(self) -> int:
        return self.attesters_per_round * self.cycle_length


def casper_roles(params: CasperParameters):
    """The oracle's node population in id order and its role columns:
    returns (nodes, roles) with roles = {n_nodes, is_att, is_bp (honest
    producers, not node 1), bp0 (the Byzantine producer's id), att_ids,
    att_cidx (committee-member index i // cycle_length), committee
    ([cycle_length, attesters_per_round] ids), prod_ids (bp0 then the
    honest producers)}, as the JAX package's make_casper builds them."""
    nb = registry_node_builders.get_by_name(params.node_builder_name)
    rd = JavaRandom(0)  # the oracle network's generator
    nodes: List[Node] = [Node(rd, nb)]  # the observer, node 0
    bp0 = Node(rd, nb, byzantine=True)  # ByzBlockProducer*, built before init
    nodes.append(bp0)
    honest = [Node(rd, nb) for _ in range(1, params.block_producers_count)]
    nodes += honest
    atts = [Node(rd, nb) for _ in range(params.attesters_count)]
    nodes += atts

    cl, apr = params.cycle_length, params.attesters_per_round
    att_ids = np.array([nd.node_id for nd in atts], np.int32)
    committee = np.zeros((cl, apr), np.int32)
    for idx, aid in enumerate(att_ids):
        committee[idx % cl, idx // cl] = aid
    n = len(nodes)
    is_att = np.zeros(n, bool)
    is_att[att_ids] = True
    is_bp = np.zeros(n, bool)
    is_bp[[nd.node_id for nd in honest]] = True
    roles = {
        "n_nodes": n,
        "is_att": is_att,
        "is_bp": is_bp,
        "bp0": bp0.node_id,
        "att_ids": att_ids,
        "att_cidx": np.arange(len(att_ids), dtype=np.int32) // cl,
        "committee": committee,
        "prod_ids": np.array([bp0.node_id] + [nd.node_id for nd in honest], np.int32),
    }
    return nodes, roles
