"""Batched PingPong: the canonical first protocol, ported to PyTorch.

Same behavior as protocols/PingPong.java and the JAX package's
protocols/pingpong_batched.py — a witness Pings everyone, each node Pongs
back, the witness counts pongs — as two vectorized message kernels.  It is
a pure message protocol (TICK_INTERVAL None), so it runs on the engine's
time-wheel store and its consensus-jump loop, which launch the
pack_bool_words, lowest_set_bit and popcount_words kernels on a CUDA
state.

On a node block (parallel.node_shard) the engine hands `deliver` the
block's own receivers: a block counts its nodes' pongs, and the Pong
replies of the row are the blocks' ping masks or-ed over the row
(`net.row_any`), so every block sends the unsharded run's rows.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.node import Node, build_node_columns
from ..core.registries import registry_network_latencies, registry_node_builders
from ..engine.core import BatchedNetwork, Emission, resolve_device
from ..engine.protocol import BatchedProtocol
from ..ops.indexing import add_at
from ..utils.javarand import JavaRandom


class BatchedPingPong(BatchedProtocol):
    MSG_TYPES = ["PING", "PONG"]
    TICK_INTERVAL = None  # pure message protocol: the engine skips empty ms
    NODE_AXIS = True  # its hooks run on a node block (parallel.node_shard)

    def __init__(self, n_nodes: int, witness: int = 0):
        self.n_nodes = n_nodes
        self.witness = witness

    def proto_init(self, n_nodes: int, device=None):
        return {"pong": torch.zeros(n_nodes, dtype=torch.int32, device=device)}

    def initial_emissions(self, net, state):
        # network.sendAll(new Ping(), witness) at t=0 -> sendTime 1
        n, dev = self.n_nodes, state.down.device
        return [
            Emission(
                mask=torch.ones((1, n), dtype=torch.bool, device=dev),
                from_idx=torch.full((n,), self.witness, dtype=torch.int32, device=dev),
                to_idx=torch.arange(n, dtype=torch.int32, device=dev),
                mtype=self.mtype("PING"),
                send_time=1,
            )
        ]

    def deliver(self, net, state, deliver_mask, t: int):
        ping = deliver_mask & (state.msg_type == self.mtype("PING"))
        pong = deliver_mask & (state.msg_type == self.mtype("PONG"))
        # on_ping: reply Pong to the sender (PingPong.java onPing)
        # on a node block: the row's replies, from every block's receivers
        emissions = [
            Emission(
                mask=net.row_any(ping),
                from_idx=state.msg_to,
                to_idx=state.msg_from,
                mtype=self.mtype("PONG"),
            )
        ]
        # on_pong: count (commutative scatter-add; view ids are in range,
        # so the JAX package's drop mode never drops)
        new_pong = add_at(state.proto["pong"], net.to_local(state.msg_to), pong.to(torch.int32))
        return state._replace(proto={"pong": new_pong}), emissions

    def all_done(self, state, net=None):
        """bool[R]: the witness has every pong.  On a node block only the
        witness's block knows; the others answer True, the neutral
        element of the engine's all-reduce over the row."""
        pong = state.proto["pong"]
        lo = net.cell.lo if net is not None and net.node_block else 0
        if not lo <= self.witness < lo + pong.shape[1]:
            return torch.ones(pong.shape[0], dtype=torch.bool, device=pong.device)
        return pong[:, self.witness - lo] >= self.n_nodes


def make_pingpong(
    node_ct: int = 1000,
    node_builder_name: Optional[str] = None,
    network_latency_name: Optional[str] = None,
    capacity: Optional[int] = None,
    seed: int = 0,
    wheel_rows: Optional[int] = None,
    telemetry=None,
    device=None,  # None = CUDA; "cpu" runs the plain versions
):
    """Host-side construction mirroring PingPong.init(): the node
    population from the oracle's JavaRandom stream, as struct-of-arrays
    columns; returns (net, single-replica state).  wheel_rows=None is the
    512-row wheel, 0 the flat store."""
    dev = resolve_device(device)
    nb = registry_node_builders.get_by_name(node_builder_name)
    latency = registry_network_latencies.get_by_name(network_latency_name)
    rd = JavaRandom(0)
    nodes = [Node(rd, nb) for _ in range(node_ct)]
    cols = build_node_columns(nodes, getattr(latency, "city_index", None))
    proto = BatchedPingPong(node_ct)
    cap = capacity if capacity is not None else 2 * node_ct + 64
    net = BatchedNetwork(
        proto, latency, node_ct, capacity=cap, wheel_rows=wheel_rows,
        telemetry=telemetry, device=dev,
    )
    state = net.init_state(cols, seed=seed, proto=proto.proto_init(node_ct, device=dev))
    return net, state
