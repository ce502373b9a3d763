"""Batched SanFerminCappos, ported to PyTorch: the San Fermin variant with
multi-candidate swaps, per-level signature caches and level timeouts.

A line-for-line port of the JAX package's
protocols/sanfermin_cappos_batched.py — its module docstring gives the
model: no pending set (every Swap at the receiver's level from a
candidate triggers the transition), the aggregate derived from the
`[N, W+1]` cache as totalNumberOfSigs(l) = 1 + the best cached value of
every level >= l, and goNextLevel's futur-skip recursion as a descent
over the levels with shrinking masks; the XOR candidate blocks and their
walk are SanFerminSignature's (`sanfermin_batched.candidate_walk`,
`walk_partner`).  What changes here is representation and how far the
descent runs, never the result:

  * every tensor carries the replica axis R in front ([R, N, ...]); the
    clock `t` is the engine's host int;
  * `deliver` compacts the delivered rows of the view (one device read,
    `ops.indexing.live_rows`) and keeps their view order, so the
    lowest-slot transition winner is JAX's; the tick's swap emission
    carries only its live rows (one more read), node-major, and goes out
    with no rows, keeping its send counter, when no node sends;
  * JAX unrolls the descent over all W + 1 levels every tick.  A pass
    with no active node changes nothing, and which nodes stay active is
    known before the descent (a committing node goes on through the run
    of cached levels below its level), so the port counts the passes
    that have an active node (`_descent_passes`, one device read) and
    runs only those: none on a tick without a commit.

SanFerminCappos ticks every millisecond on the 512-row wheel, as
SanFermin does; its loop launches no hand-written kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.node import build_node_columns
from ..core.registries import registry_network_latencies
from ..engine.core import BatchedNetwork, Emission, resolve_device
from ..engine.protocol import BatchedProtocol
from ..ops.indexing import delivered_rows, live_rows, lowest_slot, put_cells, take, take_won
from ..utils.more_math import log2
from .sanfermin import sanfermin_population
from .sanfermin_batched import block_size, candidate_walk, walk_partner
from .sanfermin_cappos import SanFerminParameters


class BatchedSanFerminCappos(BatchedProtocol):
    MSG_TYPES = ["SWAP"]
    PAYLOAD_WIDTH = 3  # (level, value, want_reply)
    TICK_INTERVAL = 1

    def __init__(self, params: SanFerminParameters):
        self.params = params
        self.n_nodes = params.node_count
        self.w = log2(self.n_nodes)
        assert 1 << self.w == self.n_nodes, "node_count must be a power of two"
        # contacts per send: the exact candidate + candidate_count walkers,
        # capped at the largest block
        self.k = 1 + min(params.candidate_count, self.n_nodes // 2)

    def msg_size(self, mtype: int) -> int:
        return 4 + self.params.signature_size  # Swap.size (:48-50)

    def proto_init(self, n_nodes: int, device=None):
        """Protocol state for one replica (no leading replica axis); the
        t=1 goNextLevel's sends are pre-applied (cursor, timeout)."""
        dev = resolve_device(device)
        w = self.w

        def full(v, dtype=torch.int32, shape=(n_nodes,)):
            return torch.full(shape, v, dtype=dtype, device=dev)

        return {
            "cpl": full(w - 1),
            "done": full(False, torch.bool),
            "thr_done": full(False, torch.bool),
            "thr_at": full(0),
            "swapping": full(False, torch.bool),
            "swap_lvl": full(0),
            "swap_val": full(0),
            "swap_t": full(0),
            "cache_best": full(0, shape=(n_nodes, w + 1)),
            "cache_any": full(False, torch.bool, (n_nodes, w + 1)),
            "cursor": full(self.k),
            "tmo_t": full(1 + self.params.timeout),
            "tmo_lvl": full(w - 1),
        }

    def _total_sigs(self, proto, level):
        """totalNumberOfSigs(level) [R, N]: own sig + best cached per
        level >= level (:351-358)."""
        lr = torch.arange(self.w + 1, dtype=torch.int32, device=level.device)
        m = lr >= level[..., None]
        return (1 + torch.where(m, proto["cache_best"], 0).sum(-1)).to(torch.int32)

    def _swap_rows(self, seed, cpl, cursor, mask, value):
        """Swap(cpl, value, wantReply=True) from every node in `mask` to
        its next k candidates from `cursor`: the live rows of the
        node-major [R, N * k] emission."""
        r, n = cpl.shape
        k = self.k
        dev = cpl.device
        ids = torch.arange(n, dtype=torch.int32, device=dev)
        walk = candidate_walk(self.w, seed[:, None], ids, cpl)
        partners, rows = [], []
        for j in range(k):
            partner, in_block = walk_partner(ids, walk, cursor + j)
            partners.append(partner)
            rows.append(mask & in_block)
        (live,) = live_rows([torch.stack(rows, -1).reshape(r, n * k)])
        if live is None:
            return Emission.no_rows(r, self.mtype("SWAP"), self.PAYLOAD_WIDTH, dev)
        idx, ok = live
        node = torch.div(idx, k, rounding_mode="floor")
        to = torch.gather(torch.stack(partners, -1).reshape(r, n * k), 1, idx)
        return Emission(
            mask=ok,
            from_idx=node.to(torch.int32),
            to_idx=to.clamp(0, n - 1),
            mtype=self.mtype("SWAP"),
            payload=torch.stack(
                [torch.gather(cpl, 1, node), torch.gather(value, 1, node), torch.ones_like(to)],
                -1,
            ),
        )

    def initial_emissions(self, net, state):
        """The pre-applied t=1 goNextLevel sends (bookkeeping in
        proto_init): every node contacts its first k candidates, with
        totalSigs = 1."""
        cpl = state.proto["cpl"]
        ones = torch.ones_like(cpl, dtype=torch.bool)
        return [self._swap_rows(state.seed, cpl, torch.zeros_like(cpl), ones,
                                torch.ones_like(cpl))]

    # -- message handling (onSwap, :201-241) ---------------------------------
    def deliver(self, net, state, deliver_mask, t: int):
        p = self.params
        proto = dict(state.proto)
        r, n = state.done_at.shape
        w = self.w
        idx, dm = delivered_rows(deliver_mask)
        m = idx.shape[1]
        dev = idx.device

        def view(c):
            return torch.gather(c, 1, idx)

        to, frm = view(state.msg_to).to(torch.int64), view(state.msg_from).to(torch.int64)
        lvl_p = view(state.msg_payload[..., 0]).clamp(0, w).to(torch.int64)
        val_p = view(state.msg_payload[..., 1])
        want = view(state.msg_payload[..., 2]) == 1

        is_swap = dm & (view(state.msg_type) == self.mtype("SWAP"))
        cpl, done = take(proto["cpl"], to), take(proto["done"], to)
        xorv = to ^ frm
        bs_p = 1 << (w - 1 - lvl_p).clamp(0, w)
        is_cand = (xorv >= bs_p) & (xorv < 2 * bs_p)
        node_lvl = to * (w + 1) + lvl_p  # (receiver, level) cell

        mismatch = done | (lvl_p != cpl)
        cached = take(proto["cache_any"].reshape(r, -1), node_lvl)
        # case A: stale/done receiver — cached reply or cache the offer
        a_reply = is_swap & mismatch & want & cached
        a_store = is_swap & mismatch & ~(want & cached) & is_cand
        # case B: level match — reply when asked, then maybe transition
        b_reply = is_swap & ~mismatch & want
        trigger = is_swap & ~mismatch & is_cand & ~take(proto["swapping"], to) & ~done

        # replies (both cases ship want_reply=False); case B answers with
        # totalNumberOfSigs(swap.level) — the level itself, not level+1
        # (:224-227)
        rep_val = torch.where(
            a_reply,
            take(proto["cache_best"].reshape(r, -1), node_lvl),
            take(self._total_sigs(proto, proto["cpl"]), to),
        )
        reply_em = Emission(
            mask=a_reply | b_reply,
            from_idx=to,
            to_idx=frm,
            mtype=self.mtype("SWAP"),
            payload=torch.stack([lvl_p.to(torch.int32), rep_val, torch.zeros_like(rep_val)], -1),
        )

        # case-A cache append: scatter-max per (node, level) + threshold
        proto["cache_best"] = put_cells(proto["cache_best"], node_lvl, val_p, a_store, "amax")
        proto["cache_any"] = put_cells(proto["cache_any"], node_lvl, True, a_store)
        got_store = put_cells(torch.zeros((r, n), dtype=torch.bool, device=dev), to, True,
                              a_store)
        thr = self._total_sigs(proto, proto["cpl"]) >= p.threshold
        thr_now = got_store & thr & ~proto["thr_done"] & ~proto["done"]
        proto["thr_done"] = proto["thr_done"] | thr_now
        proto["thr_at"] = torch.where(thr_now, t + 2 * p.pairing_time, proto["thr_at"])

        # transition: lowest-slot winner per node
        twin = lowest_slot(to, trigger, n)
        has_t = twin < m
        proto["swapping"] = proto["swapping"] | has_t
        proto["swap_lvl"] = torch.where(has_t, take_won(lvl_p.to(torch.int32), twin),
                                        proto["swap_lvl"])
        proto["swap_val"] = torch.where(has_t, take_won(val_p, twin), proto["swap_val"])
        proto["swap_t"] = torch.where(has_t, t + p.pairing_time, proto["swap_t"])

        return state._replace(proto=proto), [reply_em]

    # -- per-tick: commit, descend (with futur skips), timeouts --------------
    def _descent_passes(self, proto, commit) -> int:
        """The number of descent passes with an active node (one device
        read): a committing node at level c stays active through the run
        of cached levels c-1, c-2, ... and one pass more (its own level's
        pass, or the one that finds the next level uncached or finishes
        at level 0); 0 without a commit."""
        lr = torch.arange(self.w + 1, dtype=torch.int32, device=commit.device)
        below = lr < proto["cpl"][..., None]
        cached = torch.where(below, proto["cache_any"], True).to(torch.int32)
        # suffix products from the top level down: 1 while every level from
        # here up to the node's own is cached
        run = cached.flip(-1).cumprod(-1).flip(-1)
        depth = (run * below).sum(-1)
        return int(torch.where(commit, depth + 1, 0).amax())

    def _descend(self, state, proto, commit, t: int, passes: int):
        """goNextLevel with the futur-skip recursion (:306-344), `passes`
        passes of the JAX package's unrolled descent.  Returns (state,
        proto, descended)."""
        p = self.params
        w = self.w
        active = commit
        descended = torch.zeros_like(commit)
        for _ in range(passes):
            thr = self._total_sigs(proto, proto["cpl"]) >= p.threshold
            thr_now = active & thr & ~proto["thr_done"]
            proto["thr_done"] = proto["thr_done"] | thr_now
            proto["thr_at"] = torch.where(thr_now, t + 2 * p.pairing_time, proto["thr_at"])
            finish = active & (proto["cpl"] == 0)
            proto["done"] = proto["done"] | finish
            state = state._replace(
                done_at=torch.where(finish, t + 2 * p.pairing_time, state.done_at)
            )
            active = active & ~finish
            proto["cpl"] = torch.where(active, proto["cpl"] - 1, proto["cpl"])
            proto["swapping"] = proto["swapping"] & ~active
            proto["cursor"] = torch.where(active, 0, proto["cursor"])
            descended = descended | active
            # continue descending only through already-cached levels
            lvl = proto["cpl"].clamp(0, w).to(torch.int64)
            active = active & torch.gather(proto["cache_any"], 2, lvl[..., None])[..., 0]
        return state, proto, descended

    def tick(self, net, state, t: int):
        p = self.params
        proto = dict(state.proto)
        lr = torch.arange(self.w + 1, dtype=torch.int32, device=state.done_at.device)

        # commit: putCachedSig(swapLvl, swapVal) then goNextLevel
        commit = proto["swapping"] & (t >= proto["swap_t"]) & (proto["swap_t"] > 0)
        at_lvl = commit[..., None] & (lr == proto["swap_lvl"][..., None])
        proto["cache_best"] = torch.where(
            at_lvl, torch.maximum(proto["cache_best"], proto["swap_val"][..., None]),
            proto["cache_best"],
        )
        proto["cache_any"] = proto["cache_any"] | at_lvl

        state, proto, descended = self._descend(
            state, proto, commit, t, self._descent_passes(proto, commit))
        proto["swapping"] = proto["swapping"] & ~commit

        # timeout: re-pick while the level is unchanged (:282-291)
        tmo = (
            ~proto["done"]
            & (proto["tmo_t"] > 0)
            & (t >= proto["tmo_t"])
            & (proto["tmo_lvl"] == proto["cpl"])
        )
        stale = (proto["tmo_t"] > 0) & (t >= proto["tmo_t"])
        proto["tmo_t"] = torch.where(stale, 0, proto["tmo_t"])

        # tryNextNodes: Swap(cpl, totalSigs(cpl+1), wantReply=True) to the
        # next k candidates; arm the (single live) timeout
        send = (descended & ~proto["done"]) | tmo
        send = send & (proto["cursor"] < block_size(self.w, proto["cpl"]))
        cpl, cursor = proto["cpl"], proto["cursor"]
        em = self._swap_rows(state.seed, cpl, cursor, send,
                             self._total_sigs(proto, cpl + 1))
        proto["cursor"] = torch.where(send, cursor + self.k, cursor)
        proto["tmo_t"] = torch.where(send, t + 1 + p.timeout, proto["tmo_t"])
        proto["tmo_lvl"] = torch.where(send, cpl, proto["tmo_lvl"])
        return net.apply_emission(state._replace(proto=proto), em, t)

    def all_done(self, state):
        return state.proto["done"].all(-1)


def make_sanfermin_cappos(
    params: Optional[SanFerminParameters] = None,
    capacity: int = 1 << 14,
    seed: int = 0,
    device=None,  # None = CUDA; "cpu" runs the plain versions
):
    """Host-side construction: the oracle's node population (same
    JavaRandom stream) baked into the engine on its default 512-row time
    wheel; returns (net, single-replica state)."""
    dev = resolve_device(device)
    params = params or SanFerminParameters()
    nodes = sanfermin_population(params)
    latency = registry_network_latencies.get_by_name(params.network_latency_name)
    cols = build_node_columns(nodes, getattr(latency, "city_index", None))
    proto = BatchedSanFerminCappos(params)
    net = BatchedNetwork(proto, latency, params.node_count, capacity=capacity, device=dev)
    state = net.init_state(cols, seed=seed, proto=proto.proto_init(params.node_count, device=dev))
    return net, state
