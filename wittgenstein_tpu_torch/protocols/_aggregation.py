"""Shared pieces of the San Fermin-style aggregation protocols (Handel,
GSFSignature): the common parameter normalization/validation and the
oracle network's bad-node draw — copies of the JAX package's
protocols/_aggregation.py and oracle Network's down-node loop, so each
protocol builds the same population from the same JavaRandom stream."""

from __future__ import annotations

from ..utils.javarand import JavaRandom


def normalize_agg_params(p) -> None:
    """Threshold/nodes_down normalization + validation shared by the
    aggregation parameter classes: -1 -> 99% default, float -> ratio of
    node_count (mirroring the reference's int vs ratio constructor
    overloads)."""
    if p.threshold == -1:
        p.threshold = int(p.node_count * 0.99)
    elif isinstance(p.threshold, float):
        p.threshold = int(p.threshold * p.node_count)
    if isinstance(p.nodes_down, float):
        p.nodes_down = int(p.nodes_down * p.node_count)
    if (
        p.nodes_down >= p.node_count
        or p.nodes_down < 0
        or p.threshold > p.node_count
        or (p.nodes_down + p.threshold > p.node_count)
    ):
        raise ValueError(f"nodeCount={p.node_count}, threshold={p.threshold}")


def choose_bad_nodes(rd: JavaRandom, node_count: int, nodes_down: int) -> set:
    """Random bad-node set; node 1 always kept up (Network.java:52-64)."""
    bad = set()
    while len(bad) < nodes_down:
        down = rd.next_int(node_count)
        if down != 1 and down not in bad:
            bad.add(down)
    return bad
