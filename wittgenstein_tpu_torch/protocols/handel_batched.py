"""Batched Handel: the north-star protocol, ported to PyTorch.

A line-for-line port of the JAX package's protocols/handel_batched.py —
its module docstring gives the model in full (the three buffer stages:
in-flight channel, candidate buffer, verification register; windowed
scoring; the improved guard; fastPath bursts; both Byzantine attacks;
the boundary view the selection scores on; the distribution-parity
approximations).  What changes here is representation only:

  * every tensor carries the replica axis R in front ([R, N, ...]), where
    the JAX code is written for one replica and vmapped;
  * packed uint32 words are int32 bit views, and uint32 arithmetic
    (the rank permutation, the selection hash) runs in int64 masked to
    32 bits;
  * the clock `t` is the engine's host int;
  * `popcount_words` and its fused-operand forms (`popcount_binop`,
    `cand_score`, `lowest_set_bit_andnot`) launch the hand-written CUDA
    kernels on a CUDA state and run their plain versions on a CPU state;
    a fused form replaces the JAX package's composed elementwise ops at a
    site with one kernel that reads each operand once.

Every phase is bit-identical to the JAX package (tests/test_torch_handel.py).

On a node block (parallel.node_shard) every hook runs on the block's
rows: `ids` are the block's global ids (`net.node_ids`), which the XOR
peer arithmetic, the rank permutation and every hash use, and the
leaves' node dim is the block's.  The sends' channel commit goes
through the exchange (`_agg_batched._channel_commit_sharded`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.node import Node, build_node_columns
from ..core.registries import registry_network_latencies, registry_node_builders
from ..engine.core import BatchedNetwork, resolve_device
from ..engine.density import NarrowLeaf, narrowest_int
from ..engine.rng import hash32, hash32_u
from ..ops.bitops import (
    cand_score,
    lowest_set_bit_andnot,
    popcount_binop,
    popcount_words,
    xor_shuffle,
)
from ..utils.javarand import JavaRandom
from ._agg_batched import INT32_MAX, BitsetAggBase, _u32_i32
from ._aggregation import choose_bad_nodes
from .handel import HandelParameters

_M32 = 0xFFFFFFFF


class BatchedHandel(BitsetAggBase):
    NODE_AXIS = True  # its hooks run on a node block (parallel.node_shard)
    CAND_SLOTS = 8  # K: arrived verification candidates per (receiver, level)
    WORD_LEAVES = ("agg", "ind", "inc", "ver_sig", "bl", "byz", "in_sig*", "cand_sig*")
    PROTO_KEYS = ("agg", "fp_left")
    CHANNEL_DEPTH = 32  # D: arrival slots per (receiver, level)
    # _select reads the END-of-previous-tick candidate and merge state;
    # False reproduces the JAX package's pre-r5 same-tick ablation lever
    BOUNDARY_VIEW = True
    # candidate-score caching: carry sizeIfIncluded, cardinality,
    # |sig ∪ ind| and the agg-intersection flag as int32 leaves, refreshed
    # where delivery merges content and where _commit moves the aggregates;
    # bit-identical either way (the JAX package's tests/test_score_cache.py)
    SCORE_CACHE = True
    CACHE_LEAF_NAMES = ("cand_s", "cand_card", "cand_wind", "cand_aggi")

    def __init__(self, params: HandelParameters):
        self.params = params
        if params.channel_depth is not None:
            if params.channel_depth <= 0:
                raise ValueError(f"channel_depth={params.channel_depth} must be positive")
            self.CHANNEL_DEPTH = params.channel_depth
        if params.cand_slots is not None:
            if params.cand_slots <= 0:
                raise ValueError(f"cand_slots={params.cand_slots} must be positive")
            self.CAND_SLOTS = params.cand_slots
        self._init_geometry(params.node_count)
        self.DERIVED_CACHE_LEAVES = self.CACHE_LEAF_NAMES if self.SCORE_CACHE else ()
        # blacklist + byzantine bitsets are carried only when an attack can
        # ever set a bit in them
        self.track_bad = bool(params.byzantine_suicide or params.hidden_byzantine)
        self.NARROW_LEAVES = self._narrow_plan()

    def _narrow_plan(self) -> tuple:
        """NARROW_LEAVES for this geometry — the JAX package's plan, bound
        for bound (its _narrow_plan docstring proves each bound)."""
        p, n, L = self.params, self.n_nodes, self.n_levels
        fp_max = max(1, min(p.fast_path, max(1, n // 2)))
        bounds = (
            ("cand_rank", 2 * n - 1, True),
            ("cand_rel", max(1, n - 1), False),
            ("ver_level", max(1, L - 1), False),
            ("ver_rel", max(1, n - 1), False),
            ("fp_level", max(1, L - 1), False),
            ("fp_left", fp_max, False),
            ("window", max(p.window_initial, p.window_maximum), False),
            ("cand_s", n, False),
            ("cand_card", n, False),
            ("cand_wind", n, False),
            ("cand_aggi", 1, False),
        )
        leaves = []
        for name, bound, sentinel in bounds:
            dt = narrowest_int(bound, reserve_sentinel=sentinel)
            if dt.itemsize < 4:
                leaves.append(NarrowLeaf(name, dt.name, bound, sentinel))
        return tuple(leaves)

    def msg_size(self, mtype: int) -> int:
        # Size = level + bit field + the signatures included + our own sig
        # (SendSigs, Handel.java:253-258)
        expected = 1 if mtype == 0 else 1 << (mtype - 1)
        return 1 + expected // 8 + 96 * 2

    # -- ranks ---------------------------------------------------------------
    def _rank(self, seed, ids, level, rel):
        """Stand-in for the reference's reception-rank permutation: one
        keyed pseudorandom PERMUTATION of [0, N) per receiver, evaluated at
        the sender's absolute id (three bijective multiply/xorshift/add
        rounds mod 2^n).  seed, ids, level and rel broadcast together;
        level is an int or a tensor."""
        if isinstance(level, int):
            bs = int(self.lv_bs[level - 1])
        else:
            bs = self._tab("lv_bs", rel.device)[(level - 1).to(torch.int64)]
        r0 = rel & (bs - 1)
        # sender's absolute id: level-l peers of receiver i are i ^ j for
        # bit index j in [bs, 2*bs)
        mask = self.n_nodes - 1
        x = (ids ^ (bs + r0)).to(torch.int64) & mask
        nbits = self.n_nodes.bit_length() - 1
        s1 = max(1, nbits // 2)
        for rnd in range(3):
            mul = hash32_u(seed, ids, 0xA11CE + rnd) | 1
            add = hash32_u(seed, ids, 0xBEEF + rnd)
            x = (x * mul) & mask  # x < 2^14, mul < 2^32: no int64 overflow
            x = x ^ (x >> (s1 + (rnd & 1)))
            x = (x + add) & mask
        return x.to(torch.int32)

    @staticmethod
    def _dyn_full_block(bs, w_pad: int):
        """[..] dynamic block sizes -> [.., w_pad] all-ones-below-bs words."""
        ar = torch.arange(w_pad, dtype=torch.int32, device=bs.device)
        bits = torch.clamp(bs[..., None] - 32 * ar, 0, 32)
        m = (torch.ones_like(bits, dtype=torch.int64) << (bits & 31)) - 1
        return torch.where(bits >= 32, -1, _u32_i32(m))

    # -- state ---------------------------------------------------------------
    def proto_init(self, n_nodes: int, pairing: np.ndarray, start_at: np.ndarray,
                   byz_rel: Optional[np.ndarray] = None, device=None):
        """Protocol state for one replica (no leading replica axis)."""
        dev = resolve_device(device)
        n, L, K = self.n_nodes, self.n_levels, self.CAND_SLOTS

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        def i32(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int32), device=dev)

        own = np.zeros((n, self.n_words), dtype=np.int32)
        own[:, 0] = 1  # bit 0 = own signature (level 0)
        in_key, in_sigs = self._channel_init(n, dev)
        cand_sigs = {
            f"cand_sig{i}": zeros(n, b.nl * K * b.w_pad) for i, b in enumerate(self.buckets)
        }
        proto = {
            "agg": i32(own),  # lastAggVerified per level block
            "ind": i32(own),  # verifiedIndSignatures
            "inc": i32(own),  # totalIncoming = agg | ind
            "in_key": in_key,
            **in_sigs,
            "displaced": i32(0),
            "cand_rank": torch.full((n, (L - 1) * K), INT32_MAX, dtype=torch.int32, device=dev),
            "cand_rel": zeros(n, (L - 1) * K),
            **cand_sigs,
            "ver_active": zeros(n, dtype=torch.bool),
            "ver_done_t": zeros(n),
            "ver_level": zeros(n),
            "ver_rel": zeros(n),
            "ver_bad": zeros(n, dtype=torch.bool),
            "ver_sig": zeros(n, self.w_max),
            "fp_left": zeros(n),
            "fp_level": zeros(n),
            "fp_off": zeros(n),
            "window": torch.full((n,), self.params.window_initial, dtype=torch.int32, device=dev),
            "pos": zeros(n, L),
            "added_cycle": torch.full((n,), self.params.extra_cycle, dtype=torch.int32, device=dev),
            "sigs_checked": zeros(n),
            "msg_filtered": zeros(n),
            "pairing": i32(pairing),
            "start_at": i32(start_at),
        }
        if self.track_bad:
            proto["bl"] = zeros(n, self.n_words)
            if byz_rel is None:
                byz_rel = np.zeros((n, self.n_words), dtype=np.uint32)
            proto["byz"] = torch.as_tensor(np.asarray(byz_rel).view(np.int32), device=dev)
        if self.SCORE_CACHE:
            proto.update(self._recompute_cache_dict(proto))
        return self.narrow_proto(proto)

    # -- candidate-score caches (SCORE_CACHE) --------------------------------
    def _recompute_cache_dict(self, proto) -> dict:
        """From-scratch values of the four candidate-score cache leaves from
        (cand_sig*, inc, ind, agg): per slot, cand_s = sizeIfIncluded,
        cand_card = |sig|, cand_wind = |sig ∪ ind|, cand_aggi =
        [sig ∩ lastAgg ≠ ∅].  Rank-agnostic over leading axes."""
        L, K = self.n_levels, self.CAND_SLOTS
        inc, ind, agg = proto["inc"], proto["ind"], proto["agg"]
        lead = inc.shape[:-1]
        s_p, card_p, wind_p, aggi_p = [], [], [], []
        for i, b in enumerate(self.buckets):
            s, card, wind, aggi = cand_score(
                self._sig_view(proto, i, K, prefix="cand_sig"),
                self._blocks(inc, b), self._blocks(ind, b), self._blocks(agg, b),
            )
            s_p.append(s)
            card_p.append(card)
            wind_p.append(wind)
            aggi_p.append(aggi)

        def flat(ps):
            return torch.cat(ps, dim=-2).reshape(lead + ((L - 1) * K,))

        return {
            "cand_s": flat(s_p),
            "cand_card": flat(card_p),
            "cand_wind": flat(wind_p),
            "cand_aggi": flat(aggi_p),
        }

    def recompute_caches(self, state) -> dict:
        if not self.SCORE_CACHE:
            return {}
        caches = self._recompute_cache_dict(self.widen_proto(state.proto))
        return self.narrow_proto(caches)

    # -- tick phase 1: commit due verifications ------------------------------
    def _commit(self, net, state, t: int):
        """updateVerifiedSignatures at t = selection + pairingTime
        (Handel.java:686-750), one stacked body per width bucket."""
        p = self.params
        proto = state.proto
        L = self.n_levels
        dev = state.done_at.device
        r, n = state.done_at.shape  # n: this engine's node rows
        ids = net.node_ids(dev)

        due = proto["ver_active"] & (t >= proto["ver_done_t"])
        good = due & ~proto["ver_bad"]

        rel = proto["ver_rel"]
        new_bl = None
        if self.track_bad:
            # bad sig: blacklist the sender, nothing else (:687-694)
            bad = due & proto["ver_bad"]
            oh_full = self._onehot(rel, self.n_words)
            new_bl = torch.where(bad[..., None], proto["bl"] | oh_full, proto["bl"])

        agg, ind, inc = proto["agg"], proto["ind"], proto["inc"]
        lvl = proto["ver_level"]
        improved_any = torch.zeros_like(good)
        just_completed = torch.zeros_like(good)
        ind_pieces, agg_pieces, inc_pieces = [], [], []
        for i, b in enumerate(self.buckets):
            lv = self._tab(f"b{i}_lv", dev)
            bs = self._tab(f"b{i}_bs", dev)
            m = good[..., None] & (lvl[..., None] == lv)  # [R, N, nl]
            r0 = rel[..., None] & (bs - 1)
            sig_b = proto["ver_sig"][..., None, : b.w_pad]  # zero above w[lvl]
            ind_b = self._blocks(ind, b)  # [R, N, nl, w_pad]
            agg_b = self._blocks(agg, b)
            inc_b = self._blocks(inc, b)
            sender = self._onehot(r0, b.w_pad)

            new_ind_b = ind_b | sender
            # the improved guard: extend/replace lastAgg ONLY when the
            # candidate plus individuals is strictly larger (:716-722)
            improved2 = popcount_binop(sig_b, new_ind_b, "or") > popcount_words(new_ind_b)
            inter = popcount_binop(agg_b, sig_b, "and") > 0
            new_agg_b = torch.where(
                (improved2 & inter)[..., None],
                sig_b.expand(agg_b.shape),
                agg_b | torch.where(improved2[..., None], sig_b, 0),
            )
            new_inc_b = torch.where(
                improved2[..., None], new_agg_b | new_ind_b, inc_b | sender
            )
            improved1 = popcount_binop(inc_b, sender, "and") == 0
            improved = m & (improved1 | improved2)

            before_full = popcount_words(inc_b) == bs
            after_full = popcount_words(new_inc_b) == bs
            just_completed = just_completed | torch.any(
                improved & after_full & ~before_full, dim=-1
            )
            improved_any = improved_any | torch.any(improved, dim=-1)

            ind_pieces.append(torch.where(m[..., None], new_ind_b, ind_b))
            agg_pieces.append(torch.where((m & improved2)[..., None], new_agg_b, agg_b))
            inc_pieces.append(torch.where(m[..., None], new_inc_b, inc_b))

        ind = self._assemble(ind, ind_pieces)
        agg = self._assemble(agg, agg_pieces)
        inc = self._assemble(inc, inc_pieces)

        total = popcount_words(inc)
        done_now = improved_any & (state.done_at == 0) & ~state.down & (total >= p.threshold)
        cache_fix = {}
        if self.SCORE_CACHE:
            # a good commit moves (inc, ind, agg) at exactly ver_level, so
            # only that level's K cache slots are re-derived
            K = self.CAND_SLOTS
            cs3 = proto["cand_s"].reshape(r, n, L - 1, K)
            cw3 = proto["cand_wind"].reshape(r, n, L - 1, K)
            ca3 = proto["cand_aggi"].reshape(r, n, L - 1, K)
            lv_rows = torch.arange(L - 1, dtype=torch.int32, device=dev)
            for i, b in enumerate(self.buckets):
                mlev = good & (lvl >= b.lo) & (lvl <= b.hi)
                li = torch.clamp(lvl - b.lo, 0, b.nl - 1).to(torch.int64)
                c_sig = self._sig_view(proto, i, K, prefix="cand_sig")  # [R,N,nl,K,w]
                sig_lv = torch.gather(
                    c_sig, 2, li[..., None, None, None].expand(r, n, 1, K, b.w_pad)
                )[:, :, 0]  # [R, N, K, w_pad]
                lw = li[..., None, None].expand(r, n, 1, b.w_pad)
                inc_lv = torch.gather(self._blocks(inc, b), 2, lw)[:, :, 0]
                ind_lv = torch.gather(self._blocks(ind, b), 2, lw)[:, :, 0]
                agg_lv = torch.gather(self._blocks(agg, b), 2, lw)[:, :, 0]
                s_lv, _, wind_lv, aggi_lv = cand_score(sig_lv, inc_lv, ind_lv, agg_lv)
                lm = mlev[..., None] & (lv_rows == (lvl - 1)[..., None])
                cs3 = torch.where(lm[..., None], s_lv[:, :, None, :], cs3)
                cw3 = torch.where(lm[..., None], wind_lv[:, :, None, :], cw3)
                ca3 = torch.where(lm[..., None], aggi_lv[:, :, None, :], ca3)
            cache_fix = {
                "cand_s": cs3.reshape(r, n, (L - 1) * K),
                "cand_wind": cw3.reshape(r, n, (L - 1) * K),
                "cand_aggi": ca3.reshape(r, n, (L - 1) * K),
            }
        upd = dict(agg=agg, ind=ind, inc=inc, ver_active=proto["ver_active"] & ~due, **cache_fix)
        if self.track_bad:
            upd["bl"] = new_bl
        state = state._replace(
            done_at=torch.where(done_now, t, state.done_at),
            proto=dict(proto, **upd),
        )

        # fastPath burst (:738-742): on completing a level's incoming set,
        # contact fast_path peers of the first higher level whose outgoing
        # is complete but whose incoming is not, draining through a
        # register over two ticks (ceil(fp/2) peers per tick)
        if p.fast_path > 0 and L > 1:
            out_done = self._level_stats(
                [
                    popcount_words(self._lows(inc, b)) == self._tab(f"b{i}_bs", dev)
                    for i, b in enumerate(self.buckets)
                ]
            )
            inc_done = self._level_stats(
                [
                    popcount_words(self._blocks(inc, b)) == self._tab(f"b{i}_bs", dev)
                    for i, b in enumerate(self.buckets)
                ]
            )
            target_ok = out_done & ~inc_done  # [R, N, L-1]
            has_target = torch.any(target_ok, dim=-1)
            lsel = (torch.argmax(target_ok.to(torch.uint8), dim=-1) + 1).to(torch.int32)
            fp_mask_base = just_completed & has_target
            fp = min(p.fast_path, max(1, self.n_nodes // 2))

            fp_left = torch.where(fp_mask_base, fp, proto["fp_left"])
            fp_level = torch.where(fp_mask_base, lsel, proto["fp_level"])
            fp_off = torch.where(
                fp_mask_base, hash32(state.seed[:, None], ids, lsel, t), proto["fp_off"]
            )
            rr = (fp + 1) // 2  # peers contacted per tick; burst drains in 2
            firing = fp_left > 0
            bs_sel = self._tab("lv_bs", dev)[torch.clamp(fp_level - 1, min=0).to(torch.int64)]
            ar = torch.arange(rr, dtype=torch.int32, device=dev)
            ks = (fp - fp_left)[..., None] + ar
            m_rows = firing[..., None] & (ar < fp_left[..., None]) & (ks < bs_sel[..., None])
            rel_fp = bs_sel[..., None] + ((fp_off[..., None] + ks) & (bs_sel[..., None] - 1))
            content = [
                torch.repeat_interleave(self._dyn_low(inc, fp_level, b), rr, dim=1)
                for b in self.buckets
            ]
            state = state._replace(
                proto=dict(
                    state.proto,
                    fp_left=torch.clamp(fp_left - rr, min=0),
                    fp_level=fp_level,
                    fp_off=fp_off,
                )
            )
            state = self._send_stacked(
                net,
                state,
                t,
                m_rows.reshape(r, -1),
                torch.repeat_interleave(ids, rr),
                (ids[:, None] ^ rel_fp).reshape(r, -1),
                torch.repeat_interleave(fp_level, rr, dim=1),
                content,
            )
        return state

    # -- tick phase 2: deliver due channel slots into the candidate buffer ---
    def _channel_deliver(self, net, state, t: int):
        """onNewSig (Handel.java:752-786): due in-flight slots become
        verification candidates; the buffer keeps the top-K by
        (sizeIfIncluded, rank) among survivors of the curation rule."""
        proto = state.proto
        L, D, K = self.n_levels, self.CHANNEL_DEPTH, self.CAND_SLOTS
        dev = state.done_at.device
        r, n = state.done_at.shape
        ids = net.node_ids(dev)
        rel_mask = (1 << self.rel_bits) - 1
        ss = D + 1
        lv_all = self._tab("lv_all", dev)

        in_key, due_all, empty_tpl = self._advance_channel(proto["in_key"], t)

        keys3 = self._keys_stacked(in_key)  # [R, N, L-1, ss]
        due3 = due_all.reshape(r, n, L - 1, ss)
        # only arrival slot (t mod D) and the fresh slot can be due at t
        keys2, due2 = self._due_pair_keys(keys3, due3, t)  # [R, N, L-1, 2]
        rel2 = keys2 & rel_mask

        started = t >= proto["start_at"]
        not_done = state.done_at == 0
        filtered = (due2 & ~not_done[..., None, None]).sum(dim=(-2, -1)).to(torch.int32)

        # onNewSig drop filters: not started, done, blacklisted sender
        accept = due2 & started[..., None, None] & not_done[..., None, None]
        if self.track_bad:
            accept = accept & (self._getbit(proto["bl"], rel2) == 0)

        # rank + verified-sender demotion (receptionRanks += nodeCount)
        ind_bit = self._getbit(proto["ind"], rel2)
        rank2 = self._rank(
            state.seed.view(r, 1, 1, 1), ids[:, None, None], lv_all[None, :, None], rel2
        ) + self.n_nodes * ind_bit
        rank2 = torch.where(accept, rank2, INT32_MAX)

        inc, ind = proto["inc"], proto["ind"]
        bl = proto["bl"] if self.track_bad else None
        agg = proto["agg"]
        rank_pieces, rel_pieces = [], []
        s_pieces, card_pieces, wind_pieces, aggi_pieces = [], [], [], []
        cand_sig_updates = {}
        for i, b in enumerate(self.buckets):
            sl = slice(b.lo - 1, b.hi)  # level rows of this bucket
            sig_new = self._due_pair_sig(proto, i, t)  # [R, N, nl, 2, w_pad]
            rank_new = rank2[:, :, sl, :]
            rel_new = rel2[:, :, sl, :]

            # merge [K existing + 2 new], keep top-K by (sizeIfIncluded, -rank)
            c_rank = proto["cand_rank"].reshape(r, n, L - 1, K)[:, :, sl, :]
            c_rel = proto["cand_rel"].reshape(r, n, L - 1, K)[:, :, sl, :]
            c_sig = self._sig_view(proto, i, K, prefix="cand_sig")

            all_rank = torch.cat([c_rank, rank_new], dim=-1)  # [R, N, nl, K+2]
            all_rel = torch.cat([c_rel, rel_new], dim=-1)
            all_sig = torch.cat([c_sig, sig_new], dim=-2)
            valid = all_rank != INT32_MAX

            inc_b = self._blocks(inc, b)  # [R, N, nl, w_pad]
            ind_b = self._blocks(ind, b)
            if self.SCORE_CACHE:
                # only the two due slots pay popcounts; the K resident
                # slots' quantities ride in the caches
                new = cand_score(sig_new, inc_b, ind_b, self._blocks(agg, b))
                all_s, all_card, all_wind, all_aggi = (
                    torch.cat([proto[leaf].reshape(r, n, L - 1, K)[:, :, sl, :], x], dim=-1)
                    for leaf, x in zip(self.CACHE_LEAF_NAMES, new)
                )
                s = all_s
            else:
                s = cand_score(all_sig, inc_b, ind_b)[0]  # sizeIfIncluded
            cur = popcount_words(inc_b)
            keep = valid & (s > cur[..., None])
            if self.track_bad:
                keep = keep & (self._getbit(bl, all_rel) == 0)

            # sort key: higher sizeIfIncluded first, then lower rank;
            # bounded (s <= bs <= N/2, rank < 3N) so s*4N + rank fits int32
            r4 = 4 * self.n_nodes
            skey = torch.where(keep, s * r4 + (r4 - 1 - torch.clamp(all_rank, max=r4 - 1)), -1)
            # jnp.argsort is stable: ties keep slot order
            order = torch.sort(-skey, dim=-1, stable=True).indices[..., :K]
            top_keep = torch.gather(skey, -1, order) >= 0
            sel_rank = torch.where(top_keep, torch.gather(all_rank, -1, order), INT32_MAX)
            sel_rel = torch.gather(all_rel, -1, order)
            sel_sig = torch.gather(all_sig, -2, order[..., None].expand(order.shape + (b.w_pad,)))

            rank_pieces.append(sel_rank)
            rel_pieces.append(sel_rel)
            cand_sig_updates[f"cand_sig{i}"] = sel_sig.reshape(r, n, b.nl * K * b.w_pad)
            if self.SCORE_CACHE:
                s_pieces.append(torch.gather(all_s, -1, order))
                card_pieces.append(torch.gather(all_card, -1, order))
                wind_pieces.append(torch.gather(all_wind, -1, order))
                aggi_pieces.append(torch.gather(all_aggi, -1, order))

        def flat(ps):
            return torch.cat(ps, dim=2).reshape(r, n, (L - 1) * K)

        cache_updates = {}
        if self.SCORE_CACHE:
            cache_updates = {
                "cand_s": flat(s_pieces),
                "cand_card": flat(card_pieces),
                "cand_wind": flat(wind_pieces),
                "cand_aggi": flat(aggi_pieces),
            }
        return state._replace(
            proto=dict(
                proto,
                in_key=torch.where(due_all, empty_tpl, in_key),
                cand_rank=flat(rank_pieces),
                cand_rel=flat(rel_pieces),
                msg_filtered=proto["msg_filtered"] + filtered,
                **cand_sig_updates,
                **cache_updates,
            )
        )

    # -- tick phase 3: periodic dissemination --------------------------------
    def _dissemination(self, net, state, t: int):
        """Periodic doCycle over open levels (Handel.java:331-343, 452-480),
        all levels in ONE stacked send."""
        p = self.params
        proto = state.proto
        L = self.n_levels
        dev = state.done_at.device
        r, n = state.done_at.shape
        ids = net.node_ids(dev)
        lv_all = self._tab("lv_all", dev)
        bs_all = self._tab("lv_bs", dev)

        start = proto["start_at"] + 1
        on_beat = (t >= start) & (torch.fmod(t - start, p.dissemination_period_ms) == 0)
        is_done = state.done_at > 0
        may_send = on_beat & ~state.down & (~is_done | (proto["added_cycle"] > 0))
        new_added = torch.where(
            on_beat & is_done & (proto["added_cycle"] > 0),
            proto["added_cycle"] - 1,
            proto["added_cycle"],
        )

        inc = proto["inc"]
        opened = t >= (lv_all - 1) * p.level_wait_time  # [L-1]
        complete = self._level_stats(
            [
                popcount_words(self._lows(inc, b)) == self._tab(f"b{i}_bs", dev)
                for i, b in enumerate(self.buckets)
            ]
        )
        mask = may_send[..., None] & (opened | complete)  # [R, N, L-1]

        offset = hash32(state.seed[:, None, None], ids[:, None], lv_all) & (bs_all - 1)
        pos = proto["pos"][..., 1:]
        rel = bs_all + ((pos + offset) & (bs_all - 1))
        new_pos = torch.cat([proto["pos"][..., :1], torch.where(mask, pos + 1, pos)], dim=-1)
        state = state._replace(proto=dict(proto, added_cycle=new_added, pos=new_pos))

        # content: each level sends its outgoing prefix (zeros for levels
        # outside a bucket — those rows are masked in the scatter)
        content = []
        for b in self.buckets:
            lows = self._lows(inc, b)  # [R, N, nl, w_pad]
            full = torch.cat(
                [
                    lows.new_zeros((r, n, b.lo - 1, b.w_pad)),
                    lows,
                    lows.new_zeros((r, n, L - 1 - b.hi, b.w_pad)),
                ],
                dim=2,
            )
            content.append(full.reshape(r, n * (L - 1), b.w_pad))

        return self._send_stacked(
            net,
            state,
            t,
            mask.reshape(r, -1),
            torch.repeat_interleave(ids, L - 1),
            (ids[:, None] ^ rel).reshape(r, -1),
            lv_all.repeat(n).expand(r, n * (L - 1)),
            content,
        )

    # -- tick phase 4: start new verifications (checkSigs) -------------------
    def _select(self, net, state, t: int, view=None):
        """bestToVerify per level + uniform cross-level choice + attacks +
        window adaptation (Handel.java:566-630, 788-837).  `view` holds
        the BOUNDARY state (candidates and aggregates as of the end of the
        previous tick); candidate write-backs target the viewed entry by
        (rank, cardinality) identity against the current slots."""
        p = self.params
        proto = state.proto
        v = proto if view is None else {**proto, **view}
        L, K = self.n_levels, self.CAND_SLOTS
        dev = state.done_at.device
        r, n = state.done_at.shape
        ids = net.node_ids(dev)
        seed2 = state.seed[:, None]

        # busy gate from CURRENT state; everything the selection SCORES on
        # comes from the boundary view
        free = ~proto["ver_active"] & ~state.down & (t >= proto["start_at"] + 1)
        window = proto["window"]
        inc, ind, agg = v["inc"], v["ind"], v["agg"]
        bl = v["bl"] if self.track_bad else None
        byz = proto["byz"] if self.track_bad else None

        has_p, b_rank_p, b_rel_p, b_bad_p, b_kidx_p = [], [], [], [], []
        widx_p, insc_p = [], []
        condemn_pieces, vcard_pieces, ccard_pieces = [], [], []
        for i, b in enumerate(self.buckets):
            sl = slice(b.lo - 1, b.hi)
            lv = self._tab(f"b{i}_lv", dev)
            bs = self._tab(f"b{i}_bs", dev)
            c_rank = v["cand_rank"].reshape(r, n, L - 1, K)[:, :, sl, :]
            c_rel = v["cand_rel"].reshape(r, n, L - 1, K)[:, :, sl, :]
            c_sig = self._sig_view(v, i, K, prefix="cand_sig")
            valid = c_rank != INT32_MAX

            inc_b = self._blocks(inc, b)
            ind_b = self._blocks(ind, b)
            agg_b = self._blocks(agg, b)

            # curation (bestToVerify :592-612)
            if self.SCORE_CACHE:
                s = v["cand_s"].reshape(r, n, L - 1, K)[:, :, sl, :]
                ccard_pieces.append(proto["cand_card"].reshape(r, n, L - 1, K)[:, :, sl, :])
            else:
                s, sig_card, with_ind, aggi = cand_score(c_sig, inc_b, ind_b, agg_b)
                cur_sig = self._sig_view(proto, i, K, prefix="cand_sig")
                ccard_pieces.append(popcount_words(cur_sig))
            curated = valid & (s > popcount_words(inc_b)[..., None])
            if self.track_bad:
                curated = curated & (self._getbit(bl, c_rel) == 0)
            condemn_pieces.append(valid & ~curated)

            # windowIndex = min rank over the (pre-curation valid) queue
            window_index = torch.where(valid, c_rank, INT32_MAX).amin(dim=-1)  # [R, N, nl]
            win_hi = torch.where(
                window_index < INT32_MAX - window[..., None],
                window_index + window[..., None],
                INT32_MAX,
            )
            inside = curated & (c_rank <= win_hi[..., None])

            # score (:650-664)
            agg_card = popcount_words(agg_b)  # [R, N, nl]
            if self.SCORE_CACHE:
                sig_card = v["cand_card"].reshape(r, n, L - 1, K)[:, :, sl, :]
                agg_inter = v["cand_aggi"].reshape(r, n, L - 1, K)[:, :, sl, :] > 0
                with_ind = v["cand_wind"].reshape(r, n, L - 1, K)[:, :, sl, :]
            else:
                agg_inter = aggi > 0
            vcard_pieces.append(sig_card)
            score = torch.where(
                agg_card[..., None] >= bs[:, None],
                0,
                torch.where(
                    ~agg_inter,
                    agg_card[..., None] + sig_card,
                    torch.clamp(with_ind - agg_card[..., None], min=0),
                ),
            )
            in_score = torch.where(inside & (score > 0), score, -1)
            k_in = torch.argmax(in_score, dim=-1)
            sc_in = torch.gather(in_score, -1, k_in[..., None])[..., 0]
            exists_in = sc_in > 0

            out_rank = torch.where(curated & ~inside, c_rank, INT32_MAX)
            k_out = torch.argmin(out_rank, dim=-1)
            rk_out = torch.gather(out_rank, -1, k_out[..., None])[..., 0]
            exists_out = rk_out < INT32_MAX

            kidx = torch.where(exists_in, k_in, k_out)
            lrank = torch.where(
                exists_in, torch.gather(c_rank, -1, k_in[..., None])[..., 0], rk_out
            )
            lrel = torch.gather(c_rel, -1, kidx[..., None])[..., 0]
            lhas = exists_in | exists_out
            lbad = torch.zeros_like(lhas)
            kidx = kidx.to(torch.int32)

            if p.byzantine_suicide:
                # createSuicideByzantineSig (:538-559): a forged full-block
                # sig from an eligible Byzantine peer short-circuits the
                # level's choice
                # eligible = byz & ~bl; its lowest block-local index (stand-in
                # for cursor order)
                has_byz, m_byz = lowest_set_bit_andnot(self._blocks(byz, b), self._blocks(bl, b))
                any_valid = torch.any(valid, dim=-1)
                rel_byz = bs + (m_byz & (bs - 1))
                rank_byz = self._rank(state.seed.view(r, 1, 1), ids[:, None], lv, rel_byz)
                inject = has_byz & any_valid & (rank_byz < win_hi)
                lhas = lhas | inject
                lbad = torch.where(inject, True, lbad)
                lrel = torch.where(inject, rel_byz, lrel)
                lrank = torch.where(inject, rank_byz, lrank)
                kidx = torch.where(inject, -1, kidx)

            has_p.append(lhas)
            b_rank_p.append(lrank)
            b_rel_p.append(lrel)
            b_bad_p.append(lbad)
            b_kidx_p.append(kidx)
            widx_p.append(window_index)
            insc_p.append(torch.where(exists_in, sc_in, -1))

        has = self._level_stats(has_p)  # [R, N, L-1]
        b_rank = self._level_stats(b_rank_p)
        b_rel = self._level_stats(b_rel_p)
        b_bad = self._level_stats(b_bad_p)
        b_kidx = self._level_stats(b_kidx_p)
        # curation removal by ENTRY IDENTITY (rank, cardinality)
        condemn3 = torch.cat(condemn_pieces, dim=2)  # [R, N, L-1, K]
        vrank3 = v["cand_rank"].reshape(r, n, L - 1, K)
        vcard3 = torch.cat(vcard_pieces, dim=2)
        crank3 = proto["cand_rank"].reshape(r, n, L - 1, K)
        ccard3 = torch.cat(ccard_pieces, dim=2)

        cleared = self._entry_clear(crank3, ccard3, vrank3, vcard3, condemn3)
        new_rank3 = torch.where(cleared, INT32_MAX, crank3)

        # chooseBestFromLevels: uniform among levels with a candidate (:788)
        vcount = has.sum(dim=-1).to(torch.int32)
        can = free & (vcount > 0)
        rnd = (hash32_u(seed2, t, ids, 0x5EED) >> 8).to(torch.int32)
        pick = torch.where(vcount > 0, torch.fmod(rnd, torch.clamp(vcount, min=1)), 0)
        cum = torch.cumsum(has.to(torch.int32), dim=-1)
        lidx = torch.argmax(((cum == (pick + 1)[..., None]) & has).to(torch.uint8), dim=-1)
        level_sel = (lidx + 1).to(torch.int32)

        li1 = lidx[..., None]
        sel_rank = torch.gather(b_rank, -1, li1)[..., 0]
        sel_rel = torch.gather(b_rel, -1, li1)[..., 0]
        sel_bad = torch.gather(b_bad, -1, li1)[..., 0]
        sel_kidx = torch.gather(b_kidx, -1, li1)[..., 0]
        sel_single = torch.zeros_like(can)  # hidden-byz single-bit sig marker

        if p.hidden_byzantine and L > 1:
            # HiddenByzantine.attack (:840-917), modeled at selection time
            l = L - 1
            bt = self.buckets[-1]
            bs = self.bs[l]
            inc_b = self._blocks(inc, bt)[..., -1, :]
            ind_b = self._blocks(ind, bt)[..., -1, :]
            agg_b = self._blocks(agg, bt)[..., -1, :]
            # eligible = byz & ~inc
            has_byz, m_byz = lowest_set_bit_andnot(self._blocks(byz, bt)[..., -1, :], inc_b)
            rel_byz = bs + (m_byz & (bs - 1))
            rank_byz = self._rank(seed2, ids, l, rel_byz)

            # its score: single new bit (:650-664)
            agg_card = popcount_words(agg_b)
            oh = self._onehot(m_byz & (bs - 1), bt.w_pad)
            byz_inter = popcount_binop(oh, agg_b, "and") > 0
            byz_score = torch.where(
                agg_card >= bs,
                0,
                torch.where(
                    ~byz_inter,
                    agg_card + 1,
                    torch.clamp(popcount_binop(oh, ind_b, "or") - agg_card, min=0),
                ),
            )
            widx_top = self._level_stats(widx_p)[..., -1]
            insc_top = self._level_stats(insc_p)[..., -1]
            new_widx = torch.minimum(widx_top, rank_byz)
            win_hi = torch.where(new_widx < INT32_MAX - window, new_widx + window, INT32_MAX)
            was_outside = insc_top < 0
            wins = (
                can
                & (level_sel == l)
                & (sel_kidx >= 0)
                & has_byz
                & (rank_byz < sel_rank)
                & (rank_byz <= win_hi)
                & (byz_score > 0)
                & (was_outside | (byz_score > insc_top))
            )
            sel_rel = torch.where(wins, rel_byz, sel_rel)
            sel_rank = torch.where(wins, rank_byz, sel_rank)
            sel_kidx = torch.where(wins, -1, sel_kidx)
            sel_single = wins

        # window adaptation (:823-825): float32, the JAX package's order
        wf = window.to(torch.float32)
        grown = torch.ceil(wf * p.window_increase_factor)
        shrunk = torch.floor(wf / p.window_decrease_factor)
        adapted = torch.where(sel_bad, shrunk, grown).to(torch.int32)
        adapted = torch.clamp(adapted, p.window_minimum, p.window_maximum)
        lsize = (1 << torch.clamp(level_sel - 1, min=0)).to(torch.int32)
        new_window = torch.where(can, torch.minimum(adapted, lsize), window)

        # load the chosen sig into the verification register
        bs_sel = self._tab("lv_bs", dev)[torch.clamp(level_sel - 1, min=0).to(torch.int64)]
        ver_sig = proto["ver_sig"]
        safe_k = torch.clamp(sel_kidx, min=0).to(torch.int64)
        for i, b in enumerate(self.buckets):
            m = can & (level_sel >= b.lo) & (level_sel <= b.hi)
            c_sig = self._sig_view(v, i, K, prefix="cand_sig")
            li = torch.clamp(level_sel - b.lo, 0, b.nl - 1).to(torch.int64)
            c_lv = torch.gather(
                c_sig, 2, li[..., None, None, None].expand(r, n, 1, K, b.w_pad)
            )[:, :, 0]  # [R, N, K, w_pad]
            from_buf = torch.gather(
                c_lv, 2, safe_k[..., None, None].expand(r, n, 1, b.w_pad)
            )[:, :, 0]
            full_block = self._dyn_full_block(bs_sel, b.w_pad)
            single = self._onehot(sel_rel & (bs_sel - 1), b.w_pad)
            sig_l = torch.where(
                (sel_kidx >= 0)[..., None],
                from_buf,
                torch.where(sel_single[..., None], single, full_block),
            )
            if b.w_pad < self.w_max:
                sig_l = torch.cat([sig_l, sig_l.new_zeros((r, n, self.w_max - b.w_pad))], -1)
            ver_sig = torch.where(m[..., None], sig_l, ver_sig)

        # remove the chosen buffer candidate, matched by (rank, cardinality)
        # entry identity against the chosen level's CURRENT slots
        lvl_idx = torch.clamp(level_sel - 1, min=0)
        vcard_lv = torch.gather(
            vcard3, 2, lvl_idx.to(torch.int64)[..., None, None].expand(r, n, 1, K)
        )[:, :, 0]
        sel_card = torch.gather(vcard_lv, -1, safe_k[..., None])[..., 0]
        remove = can & (sel_kidx >= 0)
        new_rank3 = self._remove_chosen(new_rank3, ccard3, lvl_idx, sel_rank, sel_card, remove)

        return state._replace(
            proto=dict(
                proto,
                cand_rank=new_rank3.reshape(r, n, (L - 1) * K),
                ver_active=torch.where(can, True, proto["ver_active"]),
                ver_done_t=torch.where(can, t + proto["pairing"], proto["ver_done_t"]),
                ver_level=torch.where(can, level_sel, proto["ver_level"]),
                ver_rel=torch.where(can, sel_rel, proto["ver_rel"]),
                ver_bad=torch.where(can, sel_bad, proto["ver_bad"]),
                ver_sig=ver_sig,
                window=new_window,
                sigs_checked=proto["sigs_checked"] + can.to(torch.int32),
            )
        )

    # -- engine hooks --------------------------------------------------------
    def tick(self, net, state, t: int):
        # NARROW_LEAVES boundary: the tick body computes on the int32 view
        state = state._replace(proto=self.widen_proto(state.proto))
        state = self._tick_impl(net, state, t)
        return state._replace(proto=self.narrow_proto(state.proto))

    def _tick_impl(self, net, state, t: int):
        # deliver first, then commit, then select on the BOUNDARY VIEW —
        # the end-of-previous-tick candidates and aggregates (the JAX
        # package's _tick_impl explains the order)
        if not self.BOUNDARY_VIEW:
            state = self._channel_deliver(net, state, t)
            state = self._commit(net, state, t)
            return self._select(net, state, t)
        pre_cand = {k: state.proto[k] for k in self._cand_keys()}
        state = self._channel_deliver(net, state, t)
        merge_keys = ("inc", "ind", "agg") + (("bl",) if self.track_bad else ())
        pre_merge = {k: state.proto[k] for k in merge_keys}
        state = self._commit(net, state, t)
        return self._select(net, state, t, view={**pre_cand, **pre_merge})

    def _cand_keys(self):
        keys = ("cand_rank", "cand_rel") + tuple(
            f"cand_sig{i}" for i in range(len(self.buckets))
        )
        if self.SCORE_CACHE:
            keys = keys + self.CACHE_LEAF_NAMES
        return keys

    def all_done(self, state, net=None):
        """bool[R]: every live node of the replica (of a node block's
        nodes, which the engine reduces over the row) has aggregated."""
        return torch.all(state.down | (state.done_at > 0), dim=-1)


def make_handel(
    params: Optional[HandelParameters] = None,
    capacity: int = 8,  # generic store unused by this protocol
    seed: int = 0,
    wheel_rows: int = 0,
    telemetry=None,
    boundary_view: bool = True,  # False = pre-r5 selection (ablation only)
    score_cache: Optional[bool] = None,  # None = on for CUDA, off on the CPU
    device=None,  # None = CUDA; "cpu" runs the plain versions
):
    """Host-side construction: build the node population with the oracle's
    RNG stream (positions, down set), bake it into the engine; returns
    (net, single-replica state).  The engine's step is always the JAX
    package's fused step."""
    dev = resolve_device(device)
    params = params or HandelParameters()
    if score_cache is None:
        # the cache trades bytes moved for carried int32 leaves — an HBM
        # economy, on for the card; on the CPU the JAX package measured
        # it a loss.  Both arms are bit-identical.
        score_cache = dev.type == "cuda"
    n = params.node_count
    nb = registry_node_builders.get_by_name(params.node_builder_name)
    latency = registry_network_latencies.get_by_name(params.network_latency_name)
    rd = JavaRandom(0)

    if params.bad_nodes is not None:
        bad = {i for i in range(n) if (params.bad_nodes >> i) & 1}
    else:
        bad = choose_bad_nodes(rd, n, params.nodes_down)

    nodes = []
    start_at = np.zeros(n, dtype=np.int32)
    for i in range(n):
        if params.desynchronized_start != 0:
            start_at[i] = rd.next_int(params.desynchronized_start)
        nodes.append(Node(rd, nb))
    down = np.array([i in bad for i in range(n)])

    pairing = np.maximum(
        1, (params.pairing_time * np.array([nd.speed_ratio for nd in nodes]))
    ).astype(np.int32)

    proto = BatchedHandel(params)
    proto.BOUNDARY_VIEW = bool(boundary_view)
    proto.SCORE_CACHE = bool(score_cache)
    proto.DERIVED_CACHE_LEAVES = proto.CACHE_LEAF_NAMES if score_cache else ()
    # beat structure: dissemination fires at t with
    # (t - (start_at + 1)) % period == 0
    proto.BEAT_PERIOD = params.dissemination_period_ms
    proto.BEAT_RESIDUES = tuple(
        sorted({int((s + 1) % params.dissemination_period_ms) for s in start_at})
    )

    # Byzantine peers as each receiver's rel-space bitset (nodes both down
    # and flagged byzantine — Handel.java:957-976)
    byz_rel = None
    if params.byzantine_suicide or params.hidden_byzantine:
        byz_abs = np.zeros(proto.n_words, dtype=np.uint32)
        for i in sorted(bad):
            byz_abs[i // 32] |= np.uint32(1 << (i % 32))
        words = torch.from_numpy(byz_abs.view(np.int32)).expand(n, proto.n_words)
        ids = torch.arange(n, dtype=torch.int32)
        byz_rel = xor_shuffle(words, ids).numpy().view(np.uint32)

    cols = build_node_columns(nodes, getattr(latency, "city_index", None))
    net = BatchedNetwork(
        proto, latency, n, capacity=capacity, wheel_rows=wheel_rows,
        telemetry=telemetry, device=dev,
    )
    state = net.init_state(
        cols,
        seed=seed,
        proto=proto.proto_init(n, pairing, start_at, byz_rel, device=dev),
        down=down,
    )
    return net, state
