"""Batched SanFerminSignature: binomial-tree pairwise aggregation, ported
to PyTorch.

A method-for-method port of the JAX package's
protocols/sanfermin_batched.py — its module docstring gives the model in
full (candidate sets as XOR blocks, one cursor per node walking a
per-(node, level) XOR bijection, the packed `pending` bitset, one live
reply timeout per node, same-tick races won by the lowest ring slot) and
the ways it approximates the reference.  What changes here is
representation only:

  * every tensor carries the replica axis R in front ([R, N, ...]);
    `pending`'s uint32 words are int32 bit views;
  * the clock `t` is the engine's host int;
  * delivery runs on the view's delivered rows only, and the tick's
    request emission carries only its live rows (one device read each
    sizes them; a masked row changes no state); without any, the
    emission goes out with no rows and keeps its send counter;
  * `pending` is updated where it changes: the descent reset is one
    select, and each contacted partner's bit is set in place, one
    candidate position at a time;
  * drop-mode scatter-min/max with repeated destinations become
    `scatter_reduce` into a trash cell, and the bool scatter-max an int32
    scatter-add tested > 0.

Every phase is bit-identical to the JAX package
(tests/test_torch_sanfermin.py).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.node import build_node_columns
from ..core.registries import registry_network_latencies
from ..engine.core import BatchedNetwork, Emission, resolve_device
from ..engine.protocol import BatchedProtocol
from ..engine.rng import hash32, to_i32
from ..ops.indexing import add_at, live_rows
from ..utils.more_math import log2
from .sanfermin import SanFerminSignatureParameters, sanfermin_population


def block_size(w: int, cpl):
    """Candidate-block size at prefix length cpl: 2^(W-cpl-1)."""
    return (1 << (w - 1 - cpl)).to(torch.int32)


def candidate_walk(w: int, seed, ids, cpl):
    """(bs, x) of node `ids`'s candidate walk at level `cpl`: the block
    size and the XOR key of its bijection (one hash per node and level,
    whatever the position)."""
    bs = block_size(w, cpl)
    return bs, hash32(seed, ids, cpl, 0x5AFE) & (bs - 1)


def walk_partner(ids, walk, position):
    """The `position`-th candidate of node `ids` on its walk
    (candidate_walk): position 0 = exact candidate (r=0), then an
    XOR-bijection walk of the rest of the block.  Returns (partner,
    valid)."""
    bs, x = walk
    q = position - 1
    p = q + (q >= x).to(torch.int32)  # skip the slot that maps to 0
    r = torch.where(position == 0, 0, p ^ x)
    return ids ^ (bs + r), position < bs


class BatchedSanFermin(BatchedProtocol):
    MSG_TYPES = ["SWAP_REQ", "SWAP_REP_OK", "SWAP_REP_NO"]
    PAYLOAD_WIDTH = 2  # (level, agg_value)
    TICK_INTERVAL = 1  # timeouts + pairing commits need per-ms ticks
    WORD_LEAVES = ("pending",)
    PROTO_KEYS = ("cpl", "pending")

    def __init__(self, params: SanFerminSignatureParameters):
        self.params = params
        self.n_nodes = params.node_count
        self.w = log2(self.n_nodes)
        assert 1 << self.w == self.n_nodes, "node_count must be a power of two"
        self.n_words = max(1, self.n_nodes // 32)

    def msg_size(self, mtype: int) -> int:
        return 4 + self.params.signature_size  # uint32 + sig (both types)

    def proto_init(self, n_nodes: int, seed: int = 0, device=None):
        """Protocol state for one replica (no leading replica axis)."""
        dev = resolve_device(device)
        w = self.w
        # the t=1 goNextLevel is pre-applied: cpl = W-1, cache[W-1] = 1 ...
        cache_val = torch.zeros((n_nodes, w + 1), dtype=torch.int32, device=dev)
        cache_val[:, w - 1] = 1
        cache_ok = torch.zeros((n_nodes, w + 1), dtype=torch.bool, device=dev)
        cache_ok[:, w - 1] = True
        # ... including its send bookkeeping (cursor/pending for the
        # exact-candidate + candidate_count initial contacts); the matching
        # emission rows are built by initial_emissions from the same seed
        cc = max(1, self.params.candidate_count)
        eng_seed = int(seed) & 0x7FFFFFFF  # the engine's init_state seed
        ids = torch.arange(n_nodes, dtype=torch.int32, device=dev)
        cpl0 = torch.full((n_nodes,), w - 1, dtype=torch.int32, device=dev)
        pending = torch.zeros((n_nodes, self.n_words), dtype=torch.int32, device=dev)
        walk = candidate_walk(self.w, eng_seed, ids, cpl0)
        for j in range(1 + cc):
            partner, ok = walk_partner(ids, walk, torch.full_like(ids, j))
            pending = torch.where(ok[:, None], pending | self._onehot_words(partner), pending)

        def full(v, dtype=torch.int32):
            return torch.full((n_nodes,), v, dtype=dtype, device=dev)

        return {
            "cpl": full(w - 1),
            "agg": full(1),
            "done": full(False, torch.bool),
            "thr_done": full(False, torch.bool),
            "thr_at": full(0),
            "swapping": full(False, torch.bool),
            "swap_add": full(0),
            "swap_t": full(0),
            "cache_val": cache_val,
            "cache_ok": cache_ok,
            "pending": pending,
            "cursor": full(1 + cc),
            "resend": full(False, torch.bool),  # NO-reply re-pick flag
            "tmo_t": full(1 + self.params.reply_timeout),
            "tmo_lvl": full(w - 1),
            "sent_req": full(0),
            "recv_req": full(0),
        }

    # -- candidate enumeration ----------------------------------------------
    def _onehot_words(self, idx):
        """Absolute-id onehot over the packed [n_words] axis."""
        cols = torch.arange(self.n_words, device=idx.device)
        bit = to_i32(torch.ones_like(idx, dtype=torch.int64) << (idx % 32).to(torch.int64))
        return torch.where(cols == (idx // 32)[..., None].to(torch.int64), bit[..., None], 0)

    def _send_requests(self, state, mask, entering, proto, t: int):
        """_send_to_nodes (SanFerminSignature.java:329-369): contact the
        next candidates — exact-first on level entry, candidate_count per
        re-pick — update pending/cursor, arm the timeout.  Entering nodes
        start the level with an empty pending set."""
        cc = max(1, self.params.candidate_count)
        k = 1 + cc
        r, n = mask.shape
        dev = mask.device
        ids = torch.arange(n, dtype=torch.int32, device=dev)
        cpl, cursor, agg = proto["cpl"], proto["cursor"], proto["agg"]
        npick = torch.where(entering, 1 + cc, cc).to(torch.int32)
        walk = candidate_walk(self.w, state.seed[:, None], ids, cpl)
        partners, rows = [], []
        for j in range(k):
            partner, in_block = walk_partner(ids, walk, cursor + j)
            partners.append(partner)
            rows.append(mask & (j < npick) & in_block)
        m = torch.stack(rows, -1)  # [R, N, k], node-major rows
        part = torch.stack(partners, -1)
        (live,) = live_rows([m.reshape(r, -1)])
        proto = dict(
            proto,
            cursor=torch.where(mask, cursor + npick, cursor),
            sent_req=proto["sent_req"] + m.sum(-1).to(torch.int32),
            # re-arm the reply timeout (one live timeout per node)
            tmo_t=torch.where(mask, t + 1 + self.params.reply_timeout, proto["tmo_t"]),
            tmo_lvl=torch.where(mask, cpl, proto["tmo_lvl"]),
        )
        if live is None:
            # an entering node sends at least its exact candidate, so with
            # no row sent no node entered a level: pending is unchanged
            return proto, Emission.no_rows(r, self.mtype("SWAP_REQ"), self.PAYLOAD_WIDTH, dev)
        idx, ok = live
        node = torch.div(idx, k, rounding_mode="floor")
        j_row = idx - node * k
        to = torch.gather(part.reshape(r, -1), 1, idx)
        # the tick's own pending (a spare word past the end takes the
        # masked rows' writes), reset for entering nodes; then pending |=
        # onehot(partner) in place, one candidate position at a time — a
        # node's rows of one position hit distinct words of its own row
        pend = proto["pending"]
        flat = torch.empty(pend.numel() + 1, dtype=pend.dtype, device=dev)
        torch.where(entering[..., None], pend.new_zeros(()), pend, out=flat[:-1].view(pend.shape))
        proto["pending"] = flat[:-1].view(pend.shape)
        nw = self.n_words
        word = (torch.arange(r, device=dev)[:, None] * n + node) * nw + (to // 32).to(torch.int64)
        bit = to_i32(torch.ones_like(word) << (to % 32).to(torch.int64))
        trash = flat.numel() - 1
        for j in range(k):
            at = torch.where(ok & (j_row == j), word, trash)
            flat[at] = flat[at] | bit
        em = Emission(
            mask=ok,
            from_idx=node.to(torch.int32),
            to_idx=to.clamp(0, n - 1),
            mtype=self.mtype("SWAP_REQ"),
            payload=torch.stack([torch.gather(cpl, 1, node), torch.gather(agg, 1, node)], -1),
        )
        return proto, em

    # -- message handling ----------------------------------------------------
    def deliver(self, net, state, deliver_mask, t: int):
        p = self.params
        proto = dict(state.proto)
        r, n = state.down.shape
        w = self.w
        dev = deliver_mask.device
        # only the delivered rows of the view, each replica's in view
        # order (the ring-slot order of the races below): one device read
        (rows,) = live_rows([deliver_mask])
        if rows is None:
            return state, [Emission.no_rows(r, self.mtype("SWAP_REP_OK"), self.PAYLOAD_WIDTH, dev)]
        idx, dm = rows
        m = idx.shape[1]

        def view(col):
            return torch.gather(col, 1, idx)

        to, frm = view(state.msg_to).to(torch.int64), view(state.msg_from).to(torch.int64)
        mtype = view(state.msg_type)
        lvl_p = view(state.msg_payload[..., 0]).clamp(0, w).to(torch.int64)
        val_p = view(state.msg_payload[..., 1])
        slot = torch.arange(m, device=dev).expand(r, m)

        is_req = dm & (mtype == self.mtype("SWAP_REQ"))
        is_ok = dm & (mtype == self.mtype("SWAP_REP_OK"))
        is_no = dm & (mtype == self.mtype("SWAP_REP_NO"))

        def at_to(col):
            return torch.gather(col, 1, to)

        cpl, done, swapping = at_to(proto["cpl"]), at_to(proto["done"]), at_to(proto["swapping"])
        node_lvl = to * (w + 1) + lvl_p  # (receiver, level) cell

        def at_lvl(col):
            return torch.gather(col.reshape(r, -1), 1, node_lvl)

        # sender in receiver's candidate set at level L:
        # (me ^ from) in [bs(L), 2*bs(L))  (SanFerminHelper.java:46-96)
        xorv = to ^ frm
        bs_p = 1 << (w - 1 - lvl_p).clamp(0, w)
        is_cand = (xorv >= bs_p) & (xorv < 2 * bs_p)

        proto["recv_req"] = add_at(proto["recv_req"], to, is_req.to(torch.int32))

        # ---- on_swap_request (:229-270) -----------------------------------
        lvl_mismatch = done | (lvl_p != cpl)
        cached = at_lvl(proto["cache_ok"])
        a1 = is_req & lvl_mismatch & cached  # stale/done, cached -> OK(cached)
        a2 = is_req & lvl_mismatch & ~cached  # stale/done, no cache -> NO(0)
        b = is_req & ~lvl_mismatch & swapping  # level match while swapping
        c_req = is_req & ~lvl_mismatch & ~swapping & is_cand  # valid swap request

        # replies: cases A1/A2/B only — a valid swap REQUEST (case C) is
        # absorbed into the receiver's transition and never answered
        rep_ok = a1 | b
        rep_val = torch.where(a1, at_lvl(proto["cache_val"]), at_to(proto["agg"]))
        rep_lvl = torch.where(a2, cpl, lvl_p.to(torch.int32))
        reply_em = Emission(
            mask=a1 | a2 | b,
            from_idx=to,
            to_idx=frm,
            mtype=torch.where(rep_ok, self.mtype("SWAP_REP_OK"), self.mtype("SWAP_REP_NO")),
            payload=torch.stack([rep_lvl, torch.where(rep_ok, rep_val, 0)], -1),
        )

        # A2 cache store (winner = lowest slot per (node, level)); only the
        # winner rows scatter
        store = a2 & is_cand
        cells = n * (w + 1)
        winner = torch.full((r, cells + 1), m, dtype=torch.int64, device=dev)
        winner = winner.scatter_reduce(1, torch.where(store, node_lvl, cells), slot, "amin")
        is_wstore = store & (torch.gather(winner, 1, node_lvl) == slot)
        w_cell = torch.where(is_wstore, node_lvl, cells)

        def put(col, vals):
            ext = torch.cat([col.reshape(r, -1), col.new_zeros(r, 1)], 1)
            return ext.scatter(1, w_cell, vals.to(col.dtype))[:, :cells].view(col.shape)

        proto["cache_val"] = put(proto["cache_val"], val_p)
        proto["cache_ok"] = put(proto["cache_ok"], torch.ones_like(store))

        # ---- on_swap_reply (:272-323) -------------------------------------
        live = ~done & (lvl_p == cpl) & ~swapping
        pend = proto["pending"].reshape(r, -1)
        pword = torch.gather(pend, 1, to * self.n_words + frm // 32)
        in_pending = ((pword >> (frm % 32)) & 1) == 1
        ok_trigger = is_ok & live & (in_pending | is_cand)
        no_trigger = is_no & live & in_pending

        # ---- transitions: winner per node among C + OK triggers -----------
        trig = c_req | ok_trigger
        twin = torch.full((r, n + 1), m, dtype=torch.int64, device=dev)
        twin = twin.scatter_reduce(1, torch.where(trig, to, n), slot, "amin")[:, :n]
        has_t = twin < m
        add_val = torch.gather(val_p, 1, twin.clamp(0, m - 1))
        proto["swapping"] = proto["swapping"] | has_t
        proto["swap_add"] = torch.where(has_t, add_val, proto["swap_add"])
        proto["swap_t"] = torch.where(has_t, t + p.pairing_time, proto["swap_t"])

        # NO replies from pending partners re-pick next candidates in the
        # tick phase (flag survives until consumed): a bool scatter-max as
        # an int32 scatter-add tested > 0
        got_no = add_at(torch.zeros((r, n), dtype=torch.int32, device=dev), to,
                        no_trigger.to(torch.int32)) > 0
        proto["resend"] = proto["resend"] | got_no
        return state._replace(proto=proto), [reply_em]

    # -- per-tick: commits, level descent, timeouts, sends -------------------
    def tick(self, net, state, t: int):
        p = self.params
        proto = dict(state.proto)
        w = self.w
        dev = state.down.device

        # 1. aggregation commit at swap_t (do_aggregate + goNextLevel,
        # :434-455, :379-419)
        commit = proto["swapping"] & (t >= proto["swap_t"]) & (proto["swap_t"] > 0)
        agg = torch.where(commit, proto["agg"] + proto["swap_add"], proto["agg"])

        thr_now = commit & ~proto["thr_done"] & (agg >= p.threshold)
        proto["thr_done"] = proto["thr_done"] | thr_now
        proto["thr_at"] = torch.where(thr_now, t + 2 * p.pairing_time, proto["thr_at"])

        finish = commit & (proto["cpl"] == 0)
        descend = commit & ~finish
        proto["done"] = proto["done"] | finish
        state = state._replace(
            done_at=torch.where(finish, t + 2 * p.pairing_time, state.done_at)
        )

        new_cpl = torch.where(descend, proto["cpl"] - 1, proto["cpl"])
        at_lvl = descend[..., None] & (
            torch.arange(w + 1, dtype=torch.int32, device=dev) == new_cpl[..., None]
        )
        proto["cache_val"] = torch.where(at_lvl, agg[..., None], proto["cache_val"])
        proto["cache_ok"] = proto["cache_ok"] | at_lvl
        proto["agg"] = agg
        proto["cpl"] = new_cpl
        proto["swapping"] = proto["swapping"] & ~commit
        proto["cursor"] = torch.where(descend, 0, proto["cursor"])
        proto["resend"] = proto["resend"] & ~commit

        # 2. reply timeout (fires while the level is unchanged, :356-366)
        tmo = (
            ~proto["done"]
            & (proto["tmo_t"] > 0)
            & (t >= proto["tmo_t"])
            & (proto["tmo_lvl"] == proto["cpl"])
        )
        # disarm on fire (or when the level moved on); _send_requests
        # re-arms for the nodes that actually send
        stale = (proto["tmo_t"] > 0) & (t >= proto["tmo_t"])
        proto["tmo_t"] = torch.where(stale, 0, proto["tmo_t"])

        # 3. sends: level entry (exact-first) or re-pick (timeout / NO)
        send = (descend | tmo | proto["resend"]) & ~proto["done"]
        send = send & (proto["cursor"] < block_size(self.w, proto["cpl"]))
        proto["resend"] = proto["resend"] & ~send
        proto, em = self._send_requests(state, send, descend, proto, t)
        return net.apply_emission(state._replace(proto=proto), em, t)

    def initial_emissions(self, net, state):
        """The pre-applied t=1 goNextLevel's sends: every node contacts its
        exact candidate (+ candidate_count more).  The matching cursor /
        pending / timeout bookkeeping is already baked into proto_init
        (same seed, same walk_partner walk), so this only builds the rows."""
        cc = max(1, self.params.candidate_count)
        k = 1 + cc
        r, n = state.down.shape
        ids = torch.arange(n, dtype=torch.int32, device=state.down.device)
        cpl = state.proto["cpl"]
        walk = candidate_walk(self.w, state.seed[:, None], ids, cpl)
        rows_mask, rows_to = [], []
        for j in range(k):
            partner, in_block = walk_partner(ids, walk, torch.full_like(cpl, j))
            rows_mask.append(in_block)
            rows_to.append(partner)
        return [
            Emission(
                mask=torch.stack(rows_mask, -1).reshape(r, -1),
                from_idx=ids.repeat_interleave(k),
                to_idx=torch.stack(rows_to, -1).reshape(r, -1).clamp(0, n - 1),
                mtype=self.mtype("SWAP_REQ"),
                payload=torch.stack(
                    [cpl.repeat_interleave(k, -1), state.proto["agg"].repeat_interleave(k, -1)],
                    -1,
                ),
            )
        ]

    def all_done(self, state):
        """bool[R]: every node of the replica has finished."""
        return torch.all(state.proto["done"], dim=-1)


def make_sanfermin(
    params: Optional[SanFerminSignatureParameters] = None,
    capacity: int = 1 << 14,
    seed: int = 0,
    device=None,  # None = CUDA; "cpu" runs the plain versions
):
    """Host-side construction: the oracle's node population (same
    JavaRandom stream, protocols/sanfermin.py) baked into the engine, on
    its default 512-row time wheel; returns (net, single-replica state)."""
    dev = resolve_device(device)
    params = params or SanFerminSignatureParameters()
    nodes = sanfermin_population(params)
    latency = registry_network_latencies.get_by_name(params.network_latency_name)
    cols = build_node_columns(nodes, getattr(latency, "city_index", None))
    proto = BatchedSanFermin(params)
    net = BatchedNetwork(proto, latency, params.node_count, capacity=capacity, device=dev)
    state = net.init_state(
        cols, seed=seed, proto=proto.proto_init(params.node_count, seed=seed, device=dev)
    )
    return net, state
