"""Batched Avalanche family (Slush / Snowflake), ported to PyTorch.

A line-for-line port of the JAX package's protocols/avalanche_batched.py
— its module docstring gives the model: a node has at most one query in
flight, so its answer book is two counter columns `cf[N, 3]` and an
`active` mask; `random_remotes`' rejection loop (K distinct uniform
picks, Slush.java:126-137) is a top-K over per-(node, nonce) hashed keys
with the self key pinned to INT32_MIN; same-tick query adoptions are won
by the lowest ring slot.  What changes here is representation only:

  * every tensor carries the replica axis R in front ([R, N, ...]); the
    clock `t` is the engine's host int;
  * the sample is `top_k_indices`, which gives `lax.top_k`'s order: keys
    descending, equal keys by lower index first.  `torch.topk` promises
    no order among ties, and the order of the picks is the order of the
    emission's rows, hence of the store's slots, which decides the
    adoption races; so the keys are made unique first;
  * `deliver` compacts the delivered rows of the view (one device read,
    `ops.indexing.live_rows`) and works on those, keeping their view
    order, so the lowest-slot winner and the answers' store slots are
    JAX's;
  * the query emission forms keys only for the nodes that start a query
    (one more device read) and carries only their rows, in node order;
    the send path hashes no row position, so the rows draw JAX's
    latencies.  Without a starter it goes out with no rows and keeps its
    send counter.

Slush and Snowflake are event-driven (TICK_INTERVAL None) on the 512-row
wheel: each jump reads the wheel's occupancy through `pack_occupied` and
`lowest_set_bit`, and with `stop_when_done` the loop's quiescence test
counts it with `popcount_words`.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..core.node import build_node_columns
from ..core.registries import registry_network_latencies
from ..engine.core import BatchedNetwork, Emission, resolve_device
from ..engine.protocol import BatchedProtocol
from ..engine.rng import hash32
from ..ops.indexing import delivered_rows, live_rows, lowest_slot, take, take_won
from ._avalanche import avalanche_population
from .slush import SlushParameters
from .snowflake import SnowflakeParameters

INT32_MIN = -(2**31)


def top_k_indices(keys: torch.Tensor, k: int) -> torch.Tensor:
    """`lax.top_k(keys, k)[1]` over the last axis of int32 keys: the k
    largest, keys descending, equal keys by lower index first.  Each key
    becomes the unique int64 `key * n + (n - 1 - index)`, whose order is
    exactly that one, so `torch.topk` has no tie to break."""
    n = keys.shape[-1]
    rev = torch.arange(n - 1, -1, -1, dtype=torch.int64, device=keys.device)
    _, picks = torch.topk(keys.to(torch.int64) * n + rev, k, dim=-1, sorted=True)
    return picks


class BatchedAvalanche(BatchedProtocol):
    """Shared engine for both protocols; `mode` picks the onAnswer rule."""

    MSG_TYPES = ["QUERY", "ANSWER"]
    PAYLOAD_WIDTH = 1  # the sender's color
    TICK_INTERVAL = None  # pure message protocol: engine may skip empty ms

    def __init__(self, params, mode: str):
        assert mode in ("slush", "snowflake")
        self.params = params
        self.mode = mode
        self.n_nodes = params.nodes_av
        self.k = params.k
        # `cf > ak` compares an int32 count with JAX's float32 ak: for an
        # integer count that is `cf > floor(float32(ak))`
        self.ak_floor = int(math.floor(np.float32(params.ak)))

    def proto_init(self, n_nodes: int, device=None):
        """Protocol state for one replica (no leading replica axis):
        init_two_colors (Slush.java:62-74), node 0 red, node 1 blue, both
        with a query in flight from t=0."""
        dev = resolve_device(device)

        def zi(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=dev)

        color = zi(n_nodes)
        color[0], color[1] = 1, 2
        active = torch.zeros(n_nodes, dtype=torch.bool, device=dev)
        active[:2] = True
        return {
            "color": color,
            "iter": zi(n_nodes),  # Slush round / Snowflake cnt
            "active": active,
            "cf": zi(n_nodes, 3),  # answers by color
            "nonce": zi(n_nodes),  # per-node query counter
        }

    # -- K distinct random remotes (Slush.java:126-137) ----------------------
    def _query_emission(self, state, start, color, nonce):
        """Emission: every node in `start` [R, N] queries K distinct
        uniform remotes (excluding itself) with its current color; the
        rows of the starting nodes only, node-major."""
        r, n = start.shape
        k = self.k
        dev = start.device
        (rows,) = live_rows([start])
        if rows is None:
            return Emission.no_rows(r, self.mtype("QUERY"), self.PAYLOAD_WIDTH, dev)
        idx, live = rows  # [R, M] starting node ids, in node order
        m = idx.shape[1]
        cols = torch.arange(n, dtype=torch.int64, device=dev)
        keys = hash32(state.seed[:, None, None], 7701, idx[..., None],
                      take(nonce, idx)[..., None], cols)  # [R, M, N]
        keys = torch.where(cols == idx[..., None], INT32_MIN, keys)  # never self
        picks = top_k_indices(keys, k)  # [R, M, K] distinct ids

        def rep(a):
            return a.repeat_interleave(k, dim=1)

        return Emission(
            mask=rep(live),
            from_idx=rep(idx).to(torch.int32),
            to_idx=picks.reshape(r, m * k).to(torch.int32),
            mtype=self.mtype("QUERY"),
            payload=rep(take(color, idx))[..., None],
        )

    def initial_emissions(self, net, state):
        p = state.proto
        return [self._query_emission(state, p["active"], p["color"], p["nonce"])]

    def deliver(self, net, state, deliver_mask, t: int):
        p = self.params
        proto = state.proto
        r, n = proto["color"].shape
        idx, live = delivered_rows(deliver_mask)
        m = idx.shape[1]

        def col(c):
            return torch.gather(c, 1, idx)

        to, frm, mt = col(state.msg_to), col(state.msg_from), col(state.msg_type)
        pay_color = col(state.msg_payload[..., 0])
        is_q = live & (mt == self.mtype("QUERY"))
        is_a = live & (mt == self.mtype("ANSWER"))

        # -- on_query: uncolored nodes adopt the winning (lowest-slot)
        # query's color and start their own query (Slush.java:141-148)
        color = proto["color"]
        win = lowest_slot(to, is_q & (take(color, to) == 0), n)
        adopts = win < m
        color = torch.where(adopts & (color == 0), take_won(pay_color, win), color)

        # every query is answered with the (post-adoption) current color
        em_answer = Emission(
            mask=is_q,
            from_idx=to,
            to_idx=frm,
            mtype=self.mtype("ANSWER"),
            payload=take(color, to)[..., None],
        )

        # -- on_answer accounting: count answers for the active query
        cell = to.to(torch.int64) * 3 + pay_color.clamp(0, 2).to(torch.int64)
        cf = proto["cf"].reshape(r, 3 * n).scatter_add(1, cell, is_a.to(torch.int32))
        cf = cf.view(r, n, 3)
        it = proto["iter"]
        active = proto["active"]
        complete = active & ((cf[..., 1] + cf[..., 2]) >= p.k)
        other = torch.where(color == 1, 2, 1)
        cf_other = torch.gather(cf, 2, other[..., None].to(torch.int64))[..., 0]
        cf_mine = torch.gather(cf, 2, color.clamp(0, 2)[..., None].to(torch.int64))[..., 0]
        flip = complete & (cf_other > self.ak_floor)
        if self.mode == "slush":
            # Slush.java:161-176: flip on opposing majority; requery while
            # round < M
            cont = complete & (it < p.m)
            it = torch.where(cont, it + 1, it)
        else:
            # Snowflake.java:170-188: flip resets cnt, confirming majority
            # increments it; requery while cnt <= B
            confirm = complete & ~flip & (cf_mine > self.ak_floor)
            it = torch.where(flip, 0, torch.where(confirm, it + 1, it))
            cont = complete & (it <= p.b)
        color = torch.where(flip, other, color).to(torch.int32)

        start = cont | adopts
        nonce = proto["nonce"] + start.to(torch.int32)
        em_query = self._query_emission(state, start, color, nonce)
        active = (active & ~complete) | start
        cf = torch.where(complete[..., None], 0, cf)

        state = state._replace(
            proto={
                "color": color,
                "iter": it.to(torch.int32),
                "active": active,
                "cf": cf,
                "nonce": nonce,
            }
        )
        return state, [em_answer, em_query]

    def all_done(self, state):
        p = state.proto
        return (p["color"] > 0).all(-1) & ~p["active"].any(-1)


def _make(params, mode: str, capacity: int, seed: int, device):
    """Host-side construction: the oracle's node layout (same builder RNG
    stream), baked into the engine on the default 512-row wheel."""
    dev = resolve_device(device)
    nodes = avalanche_population(params.nodes_av, params.node_builder_name)
    latency = registry_network_latencies.get_by_name(params.network_latency_name)
    cols = build_node_columns(nodes, getattr(latency, "city_index", None))
    proto = BatchedAvalanche(params, mode)
    net = BatchedNetwork(proto, latency, params.nodes_av, capacity=capacity, device=dev)
    state = net.init_state(cols, seed=seed, proto=proto.proto_init(params.nodes_av, device=dev))
    return net, state


def make_slush(
    params: Optional[SlushParameters] = None,
    capacity: int = 1 << 12,
    seed: int = 0,
    device=None,  # None = CUDA; "cpu" runs the plain versions
):
    return _make(params or SlushParameters(), "slush", capacity, seed, device)


def make_snowflake(
    params: Optional[SnowflakeParameters] = None,
    capacity: int = 1 << 12,
    seed: int = 0,
    device=None,  # None = CUDA; "cpu" runs the plain versions
):
    return _make(params or SnowflakeParameters(), "snowflake", capacity, seed, device)
