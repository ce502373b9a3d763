"""Batched P2PFlood: flood routing as masked frontier propagation, ported
to PyTorch.

A line-for-line port of the JAX package's protocols/p2pflood_batched.py
— its module docstring gives the model: the random graph built on the
host from the oracle's JavaRandom stream and padded into an
`[N, max_peers]` adjacency (`oracle.p2p.build_adjacency`), and
dedup-and-forward (FloodMessage.java:47-56) as a per-tick winner
reduction: of the rows delivering the same (node, flood) pair in one
tick, the lowest slot wins, marks the pair received and forwards to
every peer but its sender.  What changes here is representation only:

  * every tensor carries the replica axis R in front ([R, N, ...]); the
    clock `t` is the engine's host int;
  * `deliver` compacts the delivered rows of the view (one device read,
    `ops.indexing.live_rows`), keeping their view order, so the position
    a row has among them orders the race as its slot does;
  * the forward emission carries the winners' rows only (one more device
    read), in view order; the send path hashes no row position, and the
    spacing rank is taken over each winner's own peer rows, as in JAX.
    Without a winner it goes out with no rows and keeps its send
    counter.

On a node block (parallel.node_shard) `received` holds the block's
nodes: a block races the rows of its own receivers, and the winners'
view mask is or-ed over the row (`net.row_any`) before the forward is
built from it, so every block forwards the unsharded run's rows in view
order.  The adjacency is a static table, uploaded once per device.

The flood runs on the flat store (`wheel_rows=0`): a wave can land on
one tick, which would need wheel rows as wide as the store, as the JAX
package notes.  So its loop reads no wheel occupancy and launches no
hand-written kernel.
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
from .p2pflood import P2PFloodParameters, p2pflood_population


def forward_rows(adj: torch.Tensor, src, payload, mask, exclude):
    """The rows of `src` [R, K] forwarding to every peer except
    `exclude` [R, K]: (ok, from, to, payload, rank) as [R, K * max_peers],
    source-major; `rank` is each row's position among its source's sent
    rows (the spacing rank of `_send_multi`)."""
    r, k = src.shape
    n_peers = adj.shape[1]
    dest = adj[src.to(torch.int64)]  # [R, K, P]
    ok = mask[..., None] & (dest >= 0) & (dest != exclude[..., None])
    rank = ok.to(torch.int32).cumsum(-1) - 1

    def flat(a):
        return a.reshape(r, k * n_peers)

    def rep(a):
        return a.repeat_interleave(n_peers, dim=1)

    return flat(ok), rep(src), flat(dest.clamp(min=0)), rep(payload), flat(rank)


class BatchedP2PFlood(BatchedProtocol):
    MSG_TYPES = ["FLOOD"]
    PAYLOAD_WIDTH = 1  # flood id
    TICK_INTERVAL = None  # pure message protocol: engine may skip empty ms
    NODE_AXIS = True  # its hooks run on a node block (parallel.node_shard)

    def __init__(self, params: P2PFloodParameters, adjacency: np.ndarray, senders, device=None):
        dev = resolve_device(device)
        self.params = params
        self.adj = torch.as_tensor(np.asarray(adjacency, np.int32), device=dev)
        self._adj_host = np.asarray(adjacency, np.int32)
        self._adj_on = {str(dev): self.adj}
        self.senders = list(senders)  # flood id -> origin node id
        self.n_nodes = params.node_count
        self.n_floods = len(self.senders)

    def msg_size(self, mtype: int) -> int:
        return 1  # FloodMessage(1, ...) in P2PFlood.init

    def proto_init(self, n_nodes: int):
        """Protocol state for one replica: the senders pre-mark their own
        message (sendPeers -> addToReceived)."""
        received = torch.zeros((n_nodes, self.n_floods), dtype=torch.bool,
                               device=self.adj.device)
        received[self.senders, torch.arange(self.n_floods)] = True
        return {"received": received}

    def _adjacency(self, device) -> torch.Tensor:
        """The adjacency table on `device`, uploaded once."""
        key = str(device)
        if key not in self._adj_on:
            self._adj_on[key] = torch.as_tensor(self._adj_host, device=device)
        return self._adj_on[key]

    def _forward(self, src, fid, mask, exclude, t: int):
        """Emission: src [R, K] forwards flood fid [R, K] to all its peers
        except `exclude`, with FloodMessage's local and per-peer delays."""
        p = self.params
        ok, frm, to, pay, rank = forward_rows(self._adjacency(src.device), src, fid, mask,
                                              exclude)
        # sendPeers/_send_multi spacing: the k-th sent destination leaves
        # at base + k*(delay+1) when delay_between_sends > 0
        # (Network.java:449-467)
        spacing = (p.delay_between_sends + 1) if p.delay_between_sends > 0 else 0
        return Emission(
            mask=ok,
            from_idx=frm,
            to_idx=to,
            mtype=self.mtype("FLOOD"),
            payload=pay[..., None],
            send_time=t + 1 + p.delay_before_resent + rank * spacing,
        )

    def initial_emissions(self, net, state):
        """Every sender floods all its peers; sendPeers' base time is
        time + 1 + localDelay with time = 0 (P2PNetwork.java:127-133)."""
        r = state.seed.shape[0]
        dev = self.adj.device

        def i32(a):
            return torch.as_tensor(a, dtype=torch.int32, device=dev).expand(r, -1)

        return [self._forward(
            i32(self.senders), i32(range(self.n_floods)),
            torch.ones((r, self.n_floods), dtype=torch.bool, device=dev),
            i32([-1] * self.n_floods), 0,
        )]

    def deliver(self, net, state, deliver_mask, t: int):
        r = deliver_mask.shape[0]
        nf = self.n_floods
        received = state.proto["received"]
        idx, live = delivered_rows(deliver_mask)

        def col(c):
            return torch.gather(c, 1, idx)

        to, frm, fid = col(state.msg_to), col(state.msg_from), col(state.msg_payload[..., 0])
        # a node block's cells are its own nodes' (every node off a block)
        cell = net.to_local(to).to(torch.int64) * nf + fid
        fresh = live & ~take(received.reshape(r, -1), cell)

        # winner per (node, flood): lowest delivering slot this tick
        is_winner = first_in_cell(cell, fresh, received.shape[1] * nf)
        received = put_cells(received, cell, True, fresh)
        count = received.sum(-1)
        # onFlood: done when msg_count distinct messages held (P2PFlood.java:39-43)
        done = (count >= self.params.msg_count) & (state.done_at == 0) & ~state.down
        done_at = torch.where(done, t, state.done_at)

        if net.node_block:
            # the row's winners in view order: the blocks' or-ed view masks
            view = torch.zeros(deliver_mask.shape, dtype=torch.int32, device=deliver_mask.device)
            is_winner = net.row_any(view.scatter_add(1, idx, is_winner.to(torch.int32)) > 0)
            to, frm, fid = state.msg_to, state.msg_from, state.msg_payload[..., 0]
        (wrows,) = live_rows([is_winner])
        if wrows is None:
            em = Emission.no_rows(r, self.mtype("FLOOD"), self.PAYLOAD_WIDTH, deliver_mask.device)
        else:
            widx, wlive = wrows

            def win(c):
                return torch.gather(c, 1, widx)

            em = self._forward(win(to), win(fid), wlive, win(frm), t)
        state = state._replace(proto={"received": received}, done_at=done_at)
        return state, [em]

    def all_done(self, state, net=None):
        return torch.where(state.down, True, state.done_at > 0).all(-1)


def make_p2pflood(
    params: Optional[P2PFloodParameters] = None,
    capacity: int = 1 << 13,
    seed: int = 0,
    telemetry=None,  # a telemetry.TelemetryConfig arms the counter side-car
    device=None,  # None = CUDA; "cpu" runs the plain versions
):
    """Host-side construction: the replay of the oracle's init (graph and
    senders from the same JavaRandom stream) baked into the engine on the
    flat store; returns (net, single-replica state)."""
    dev = resolve_device(device)
    params = params or P2PFloodParameters()
    nodes, adj, down, senders = p2pflood_population(params)
    latency = registry_network_latencies.get_by_name(params.network_latency_name)
    cols = build_node_columns(nodes, getattr(latency, "city_index", None))
    proto = BatchedP2PFlood(params, adj, senders, device=dev)
    net = BatchedNetwork(proto, latency, params.node_count, capacity=capacity, wheel_rows=0,
                         telemetry=telemetry, device=dev)
    # dead nodes are down from t=0, before the initial floods go out
    state = net.init_state(cols, seed=seed, proto=proto.proto_init(params.node_count), down=down)
    if params.msg_count == 1:
        # the single sender is done at t=1 (P2PFlood.init)
        done0 = torch.zeros_like(state.done_at)
        done0[senders[0]] = 1
        state = state._replace(done_at=done0)
    return net, state
