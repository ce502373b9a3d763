"""The node population of the Avalanche family (Slush / Snowflake).

The host part of the JAX package's protocols/_avalanche.py, as the
port's own copy: `init_two_colors` (Slush.java:62-74 ==
Snowflake.java:76-88) builds `nodes_av` nodes, each drawing its position
from the oracle network's JavaRandom(0) as Node draws it, then colors
node 0 red and node 1 blue and starts their first queries.  Those
queries' `random_remotes` draws come after every node is built, so they
move no node column; the batched protocol draws its samples from its own
counter hash and reads nothing else of the generator.  The oracle's
messages and answer books are not ported.
"""

from __future__ import annotations

from typing import List, Optional

from ..core.node import Node
from ..core.registries import registry_node_builders
from ..utils.javarand import JavaRandom

COLOR_NB = 2


def avalanche_population(nodes_av: int, node_builder_name: Optional[str]) -> List[Node]:
    """The oracle's nodes in id order: `nodes_av` constructions, one
    position draw each, from the network's JavaRandom(0)."""
    rd = JavaRandom(0)
    nb = registry_node_builders.get_by_name(node_builder_name)
    return [Node(rd, nb) for _ in range(nodes_av)]
