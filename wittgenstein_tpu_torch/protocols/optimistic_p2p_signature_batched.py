"""Batched OptimisticP2PSignature, ported to PyTorch: every node's
signature floods the P2P graph; a node finishes when it holds
`threshold` distinct signatures.

A line-for-line port of the JAX package's
protocols/optimistic_p2p_signature_batched.py — its module docstring
gives the model: p2pflood's frontier reduction with the signature bitset
as a dense bool matrix `received[N, N]` (node x signature), the
oracle's popcount as a row sum, and a done node's row frozen (done nodes
neither record nor forward, OptimisticP2PSignature.java:117).  What
changes here is representation only:

  * every tensor carries the replica axis R in front ([R, N, ...]); the
    clock `t` is the engine's host int;
  * `deliver` compacts the delivered rows of the view (one device read)
    and keeps their view order, so the lowest-slot winner per (node,
    signature) is JAX's; the slot-min table is scattered from those rows
    only (`ops.indexing.first_in_cell`);
  * the forward emission carries the winners' rows only (one more device
    read), in view order, as P2PFlood's does.

It runs on the flat store (`wheel_rows=0`), as in the JAX package, so its
loop launches no hand-written kernel.  At the reference's 1000 nodes
about six million sends are in flight in the first 300 ms of a replica:
the store must hold them (capacity 1 << 23), or drops change the result.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.node import build_node_columns
from ..core.registries import registry_network_latencies
from ..engine.core import BatchedNetwork, Emission, resolve_device
from ..engine.protocol import BatchedProtocol
from ..ops.indexing import delivered_rows, first_in_cell, live_rows, put_cells, take
from .optimistic_p2p_signature import OptimisticP2PSignatureParameters, optimistic_population
from .p2pflood_batched import forward_rows


class BatchedOptimisticP2PSignature(BatchedProtocol):
    MSG_TYPES = ["SEND_SIG"]
    PAYLOAD_WIDTH = 1  # signature id (the signer's node id)
    TICK_INTERVAL = None  # pure message protocol: engine may skip empty ms

    def __init__(self, params: OptimisticP2PSignatureParameters, adjacency: np.ndarray,
                 device=None):
        self.params = params
        self.adj = torch.as_tensor(np.asarray(adjacency, np.int32), device=resolve_device(device))
        self.n_nodes = params.node_count

    def msg_size(self, mtype: int) -> int:
        return 4 + 48  # NodeId + sig (OptimisticP2PSignature.java:92)

    def proto_init(self, n_nodes: int):
        """Each node's own signature is recorded when its t=1 task runs
        on_sig on itself; baked in here, with the forward as the initial
        emission."""
        return {"received": torch.eye(n_nodes, dtype=torch.bool, device=self.adj.device)}

    def _forward(self, src, sig, mask, exclude, t: int):
        """src [R, K] forwards signature sig [R, K] to every peer except
        exclude [R, K] at t + 1 (the `network.time + 1` send in on_sig)."""
        ok, frm, to, pay, _ = forward_rows(self.adj, src, sig, mask, exclude)
        return Emission(mask=ok, from_idx=frm, to_idx=to, mtype=self.mtype("SEND_SIG"),
                        payload=pay[..., None], send_time=t + 1)

    def initial_emissions(self, net, state):
        """The per-node registered task fires at t=1 and sends at t=2
        (OptimisticP2PSignature.java:156-165: `send(ss, time+1, ...)`)."""
        r = state.seed.shape[0]
        ids = torch.arange(self.n_nodes, dtype=torch.int32, device=self.adj.device).expand(r, -1)
        return [self._forward(ids, ids, torch.ones_like(ids, dtype=torch.bool),
                              torch.full_like(ids, -1), 1)]

    def deliver(self, net, state, deliver_mask, t: int):
        p = self.params
        r, n = state.done_at.shape
        received = state.proto["received"]
        was_done = state.done_at > 0
        idx, live = delivered_rows(deliver_mask)

        def col(c):
            return torch.gather(c, 1, idx)

        to, frm, sig = col(state.msg_to), col(state.msg_from), col(state.msg_payload[..., 0])
        cell = to.to(torch.int64) * n + sig
        fresh = live & ~take(received.reshape(r, n * n), cell) & ~take(was_done, to)

        # winner per (node, signature): lowest delivering slot this tick
        is_winner = first_in_cell(cell, fresh, n * n)
        received = put_cells(received, cell, True, fresh)
        count = received.sum(-1)
        done = (count >= p.threshold) & ~was_done & ~state.down
        # doneAt = now + 2*pairingTime (OptimisticP2PSignature.java:131)
        done_at = torch.where(done, t + 2 * p.pairing_time, state.done_at)

        (wrows,) = live_rows([is_winner])
        if wrows is None:
            em = Emission.no_rows(r, self.mtype("SEND_SIG"), self.PAYLOAD_WIDTH, idx.device)
        else:
            widx, wlive = wrows

            def win(c):
                return torch.gather(c, 1, widx)

            em = self._forward(win(to), win(sig), wlive, win(frm), t)
        state = state._replace(proto={"received": received}, done_at=done_at)
        return state, [em]

    def all_done(self, state):
        return torch.where(state.down, True, state.done_at > 0).all(-1)


def make_optimistic(
    params: Optional[OptimisticP2PSignatureParameters] = None,
    capacity: int = 1 << 15,
    seed: int = 0,
    device=None,  # None = CUDA; "cpu" runs the plain versions
):
    """Host-side construction: the replay of the oracle's init (the P2P
    graph from the same JavaRandom stream) baked into the engine on the
    flat store; returns (net, single-replica state).  The default
    capacity is the JAX package's, sized for 64 nodes."""
    dev = resolve_device(device)
    params = params or OptimisticP2PSignatureParameters()
    nodes, adj = optimistic_population(params)
    latency = registry_network_latencies.get_by_name(params.network_latency_name)
    cols = build_node_columns(nodes, getattr(latency, "city_index", None))
    proto = BatchedOptimisticP2PSignature(params, adj, device=dev)
    net = BatchedNetwork(proto, latency, params.node_count, capacity=capacity, wheel_rows=0,
                         device=dev)
    state = net.init_state(cols, seed=seed, proto=proto.proto_init(params.node_count))
    return net, state
