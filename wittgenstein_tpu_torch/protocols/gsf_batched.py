"""Batched GSFSignature: north-star config #2, ported to PyTorch.

A method-for-method port of the JAX package's protocols/gsf_batched.py —
its module docstring gives the model in full (the completed-prefix
payload carried as one integer k per message in `in_aux`/`cand_pk`,
budgeted level sends, evaluateSig scoring with the global best across
levels, the individual-signature queue as pending/seen bitsets,
accelerated-call bursts, the boundary view the selection scores on).
What changes here is representation only:

  * every tensor carries the replica axis R in front ([R, N, ...]);
  * packed uint32 words are int32 bit views;
  * the clock `t` is the engine's host int;
  * evaluateSig's popcounts run as Handel's fused candidate score: one
    `cand_score(sig, ver, indiv, agg=indiv)` launch gives |sig|, the
    merged total and the sig-indiv intersection, plus one
    `popcount_words(ver)` (see `_eval_sig`); each `popcount(a op b)` site
    is one `popcount_binop` launch;
  * the static full-block table of `_commit` lives on the device once
    (`_tab`), where the JAX package rebuilds it in numpy every call.

Every phase is bit-identical to the JAX package (tests/test_torch_gsf.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.node import Node, build_node_columns
from ..core.registries import registry_network_latencies, registry_node_builders
from ..engine.core import BatchedNetwork, resolve_device
from ..engine.rng import hash32
from ..ops.bitops import block_mask, cand_score, popcount_binop, popcount_words
from ..ops.indexing import live_rows
from ..utils.javarand import JavaRandom
from ._agg_batched import INT32_MAX, BitsetAggBase
from ._aggregation import choose_bad_nodes
from .gsf import GSFSignatureParameters


class BatchedGSF(BitsetAggBase):
    CAND_SLOTS = 8  # K: score-curated verification candidates per level
    WORD_LEAVES = ("ver", "indiv", "ind_seen", "pend_ind", "ver_sig", "in_sig*", "cand_sig*")
    PROTO_KEYS = ("ver", "ind_seen")

    def __init__(self, params: GSFSignatureParameters):
        self.params = params
        self._init_geometry(params.node_count)
        L = self.n_levels
        # prefix interval masks: pref_masks[k] = bits [0, 2^k)
        self._host_tabs["pref_masks"] = np.stack(
            [block_mask(0, 1 << k, self.n_words) for k in range(L)]
        ).view(np.int32)
        # send budget per level when a commit resets it (level 0 has none)
        self._host_tabs["lv_sizes"] = np.asarray(
            [0] + [1 << (j - 1) for j in range(1, L)], np.int32
        )
        self._host_tabs["lv_idx"] = np.arange(L, dtype=np.int32)
        # absorbed commits act as a full block at the committed level:
        # [nl, w_pad] words with the level's bs low bits set
        for i, b in enumerate(self.buckets):
            self._host_tabs[f"b{i}_full"] = np.asarray(
                [
                    [
                        0xFFFFFFFF
                        if (j + 1) * 32 <= self.bs[l]
                        else ((1 << (self.bs[l] % 32)) - 1 if j * 32 < self.bs[l] else 0)
                        for j in range(b.w_pad)
                    ]
                    for l in b.levels
                ],
                np.uint32,
            ).view(np.int32)

    def msg_size(self, mtype: int) -> int:
        # Size = level byte + bit field + the aggregated sig + our own sig
        # (SendSigs, GSFSignature.java:143-164)
        expected = 1 if mtype == 0 else 1 << (mtype - 1)
        return 1 + expected // 8 + 96

    # -- state ---------------------------------------------------------------
    def proto_init(self, n_nodes: int, pairing: np.ndarray, device=None):
        """Protocol state for one replica (no leading replica axis)."""
        dev = resolve_device(device)
        n, L, K = self.n_nodes, self.n_levels, self.CAND_SLOTS
        ss = self.CHANNEL_DEPTH + 1

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
        remaining = np.zeros((n, L), dtype=np.int32)
        for l in range(1, L):
            remaining[:, l] = 1 << (l - 1)
        return {
            "ver": i32(own),  # verified union, per level blocks
            "indiv": zeros(n, self.n_words),
            "ind_seen": zeros(n, self.n_words),
            "pend_ind": zeros(n, self.n_words),
            "in_key": in_key,
            **in_sigs,
            "displaced": i32(0),
            "in_aux": zeros(n, (L - 1) * ss),  # prefix k
            "cand_key": torch.full((n, (L - 1) * K), INT32_MAX, dtype=torch.int32, device=dev),
            "cand_pk": zeros(n, (L - 1) * K),
            **cand_sigs,
            "ver_active": zeros(n, dtype=torch.bool),
            "ver_done_t": zeros(n),
            "ver_level": zeros(n),
            "ver_rel": zeros(n),
            "ver_pk": zeros(n),
            "ver_single": zeros(n, dtype=torch.bool),  # individual-sig verification
            "ver_sig": zeros(n, self.w_max),
            "remaining": i32(remaining),
            "pos": zeros(n, L),
            "sig_checked": zeros(n),
            "pairing": i32(pairing),
        }

    # -- helpers -------------------------------------------------------------
    def _prefix_k(self, ver):
        """Number of consecutively complete levels from level 1 up
        (getLastFinishedLevel): the verified union is then >= [0, 2^k)."""
        if self.n_levels == 1:
            return torch.zeros(ver.shape[:-1], dtype=torch.int32, device=ver.device)
        dev = ver.device
        comp = self._level_stats(
            [
                popcount_words(self._blocks(ver, b)) == self._tab(f"b{i}_bs", dev)
                for i, b in enumerate(self.buckets)
            ]
        )
        return torch.cumprod(comp.to(torch.int32), dim=-1).sum(-1).to(torch.int32)

    def _prefix_interval(self, k):
        """[..] prefix counts -> [.., W] words of the interval [0, 2^k)."""
        k = torch.clamp(k, 0, self.n_levels - 1).to(torch.int64)
        return self._tab("pref_masks", k.device)[k]

    @staticmethod
    def _eval_sig(sig, vb, ib, bs, lv):
        """evaluateSig (GSFSignature.java:478-520) of candidate rows sig
        [..., K, w] against node rows vb (verified) and ib (individuals)
        [..., w]; bs and lv broadcast against [..., K].  Returns
        (score, |sig|), [..., K] int32 each.

        Handel's candidate score gives it in one pass: with inc = vb,
        ind = agg = ib, s = |(sig ∩ vb ≠ ∅ ? sig : sig ∪ vb) ∪ ib| is the
        merged total wherever vb is not empty, card = |sig|, and aggi =
        [sig ∩ ib ≠ ∅]; where vb is empty the total is |sig|."""
        s, card, _, aggi = cand_score(sig, vb, ib, ib)
        vcard = popcount_words(vb)[..., None]
        new_total = torch.where(vcard == 0, card, s)
        added = torch.where(vcard == 0, card, new_total - vcard)
        indiv_fallback = ((card == 1) & (aggi == 0)).to(torch.int32)
        score = torch.where(
            added <= 0,
            indiv_fallback,
            torch.where(new_total == bs, 1_000_000 - lv * 10, 100_000 - lv * 100 + added),
        )
        return torch.where(vcard >= bs, 0, score), card

    def _full_width(self, lows, b):
        """[R, N, nl, w_pad] bucket rows -> [R, N, L-1, w_pad], zero outside
        the bucket's levels (those send rows are masked in the scatter)."""
        r, n = lows.shape[:2]
        return torch.cat(
            [
                lows.new_zeros((r, n, b.lo - 1, b.w_pad)),
                lows,
                lows.new_zeros((r, n, self.n_levels - 1 - b.hi, b.w_pad)),
            ],
            dim=2,
        )

    # -- tick phase 1: commit due verifications ------------------------------
    def _commit(self, net, state, t: int):
        """updateVerifiedSignatures (GSFSignature.java:379-460), stacked."""
        p = self.params
        proto = state.proto
        n, L = self.n_nodes, self.n_levels
        dev = state.done_at.device
        r = state.done_at.shape[0]
        ids = torch.arange(n, dtype=torch.int32, device=dev)
        lv_all = self._tab("lv_all", dev)
        bs_all = self._tab("lv_bs", dev)

        due = proto["ver_active"] & (t >= proto["ver_done_t"])
        ver, indiv = proto["ver"], proto["indiv"]
        remaining = proto["remaining"]
        rel = proto["ver_rel"]
        pk = proto["ver_pk"]
        lvl = proto["ver_level"]

        # absorb the completed prefix (:397-411) at full width first: the
        # sender's consecutive-complete levels cover [0, 2^pk), which
        # includes the committed block and the receiver's levels 1..pk
        absorb = due & (pk >= lvl)
        interval = self._prefix_interval(pk)
        newly = popcount_binop(interval, ver, "andnot") > 0
        reset_r = absorb & newly
        ver_a = torch.where(absorb[..., None], ver | interval, ver)

        improved_any = torch.zeros_like(due)
        ver_pieces, indiv_pieces = [], []
        for i, b in enumerate(self.buckets):
            lv = self._tab(f"b{i}_lv", dev)
            bs = self._tab(f"b{i}_bs", dev)
            m = due[..., None] & (lvl[..., None] == lv)  # [R, N, nl]
            r0 = rel[..., None] & (bs - 1)
            sig_b = proto["ver_sig"][..., None, : b.w_pad]
            ver_b = self._blocks(ver_a, b)  # post-absorb ("may now be complete")
            indiv_b = self._blocks(indiv, b)

            # individual sig: set the indiv bit first (:383-385)
            single = m & proto["ver_single"][..., None]
            oh = self._onehot(r0, b.w_pad)
            new_indiv_b = torch.where(single[..., None], indiv_b | oh, indiv_b)
            # holder.sigs |= indivVerifiedSig (:386)
            sigs = sig_b | new_indiv_b
            # absorbed commits act as a full block at the committed level
            sigs = torch.where(
                (m & absorb[..., None])[..., None], self._tab(f"b{i}_full", dev), sigs
            )

            # disjoint sets aggregate (:413-417)
            ver_card = popcount_words(ver_b)
            disjoint = (ver_card > 0) & (popcount_binop(sigs, ver_b, "and") == 0)
            sigs = torch.where((m & disjoint)[..., None], sigs | ver_b, sigs)

            # replacement on improvement (:419-431)
            improve = m & ((popcount_words(sigs) > ver_card) | reset_r[..., None])
            ver_pieces.append(torch.where(improve[..., None], sigs, ver_b))
            indiv_pieces.append(torch.where(m[..., None], new_indiv_b, indiv_b))
            improved_any = improved_any | torch.any(improve, dim=-1)

        ver = self._assemble(ver_a, ver_pieces)
        indiv = self._assemble(indiv, indiv_pieces)

        # reset send budgets for levels >= the committed level (:421-423)
        remaining = torch.where(
            improved_any[..., None] & (self._tab("lv_idx", dev) >= lvl[..., None]),
            self._tab("lv_sizes", dev),
            remaining,
        )
        state = state._replace(proto=dict(proto, ver=ver, indiv=indiv, remaining=remaining))

        # accelerated calls (:438-451): after the merges, burst the
        # completed prefix to fresh peers of each level it now covers.
        # Each node committed at exactly one level (ver_level); burst at
        # level mm iff the commit improved, mm > committed level, and the
        # new prefix k reaches mm-1.  One stacked send over [R, N, L-1, acc].
        if p.accelerated_calls_count > 0 and L > 2:
            k_new = self._prefix_k(ver)
            acc = p.accelerated_calls_count
            havings = ver | self._prefix_interval(k_new)
            fan = torch.clamp(bs_all, max=acc)  # [L-1]
            burst = (
                improved_any[..., None]
                & (lvl[..., None] < lv_all)
                & (k_new[..., None] >= lv_all - 1)
                & (lv_all >= 2)
            )  # [R, N, L-1]
            take = torch.where(
                burst, torch.minimum(torch.clamp(remaining[..., 1:], min=0), fan), 0
            )
            remaining = torch.cat([remaining[..., :1], remaining[..., 1:] - take], dim=-1)
            state = state._replace(proto=dict(state.proto, remaining=remaining))

            ks = torch.arange(acc, dtype=torch.int32, device=dev)
            offset = hash32(state.seed[:, None, None], ids[:, None], lv_all, t) & (bs_all - 1)
            relb = bs_all[:, None] + (
                (proto["pos"][..., 1:, None] + offset[..., None] + ks) & (bs_all[:, None] - 1)
            )  # [R, N, L-1, acc]
            mask_b = (ks < take[..., None]).reshape(r, -1)
            # only the rows that send enter the send path: a masked row
            # changes nothing there (no counter, key, slot or content, and
            # each row's latency draw hashes its own ids), and a tick
            # bursts from a few nodes of N * (L-1) * acc rows.  One device
            # read sizes the rows; each replica's rows come first, in order
            (live,) = live_rows([mask_b])
            row, sends = live if live is not None else (
                torch.zeros((r, 0), dtype=torch.int64, device=dev), mask_b[:, :0])
            pair = row // acc  # the row's (node, level) in [N * (L-1)]
            node = (pair // (L - 1)).to(torch.int32)
            content = []
            for b in self.buckets:
                full = self._full_width(self._lows(havings, b), b).reshape(r, -1, b.w_pad)
                content.append(torch.gather(full, 1, pair[..., None].expand(r, -1, b.w_pad)))
            state = self._send_stacked(
                net,
                state,
                t,
                sends,
                node,
                torch.gather((ids[:, None, None] ^ relb).reshape(r, -1), 1, row),
                (pair % (L - 1) + 1).to(torch.int32),
                content,
                aux=torch.gather(k_new, 1, node.to(torch.int64)),
            )

        proto = state.proto
        total = popcount_words(proto["ver"])
        done_now = improved_any & (state.done_at == 0) & ~state.down & (total >= p.threshold)
        return state._replace(
            done_at=torch.where(done_now, t, state.done_at),
            proto=dict(proto, ver_active=proto["ver_active"] & ~due),
        )

    # -- tick phase 2: deliver channel slots into candidates -----------------
    def _channel_deliver(self, net, state, t: int):
        """onNewSig (GSFSignature.java:560-577): enqueue the aggregate and,
        once per sender, its individual signature."""
        proto = state.proto
        n, L, K = self.n_nodes, self.n_levels, self.CAND_SLOTS
        dev = state.done_at.device
        r = state.done_at.shape[0]
        rel_mask = (1 << self.rel_bits) - 1
        ss = self.CHANNEL_DEPTH + 1

        in_key, due_all, empty_tpl = self._advance_channel(proto["in_key"], t)
        keys3 = self._keys_stacked(in_key)
        due3 = due_all.reshape(r, n, L - 1, ss)
        # only arrival slot (t mod D) and the fresh slot can be due at t
        keys2, due2 = self._due_pair_keys(keys3, due3, t)
        rel2 = keys2 & rel_mask
        pk3 = proto["in_aux"].reshape(r, n, L - 1, ss)
        pk2, _ = self._due_pair_keys(pk3, due3, t)

        ver, indiv = proto["ver"], proto["indiv"]
        seen, pend = proto["ind_seen"], proto["pend_ind"]

        key_pieces, pk_pieces = [], []
        cand_sig_updates = {}
        seen_pieces, pend_pieces = [], []
        for i, b in enumerate(self.buckets):
            sl = slice(b.lo - 1, b.hi)
            lv = self._tab(f"b{i}_lv", dev)[:, None]
            bs = self._tab(f"b{i}_bs", dev)[:, None]
            due = due2[:, :, sl, :]  # [R, N, nl, 2]
            rel = rel2[:, :, sl, :]
            r0 = rel & (bs - 1)
            sig_new = self._due_pair_sig(proto, i, t)  # [R, N, nl, 2, w_pad]
            pk_new = pk2[:, :, sl, :]

            # individual sig enqueue: once per sender per level, tracked
            # block-locally and reassembled
            oh = torch.where(due[..., None], self._onehot(r0, b.w_pad), 0)
            arrived_bits = oh[..., 0, :] | oh[..., 1, :]  # [R, N, nl, w_pad]
            seen_b = self._blocks(seen, b)
            pend_b = self._blocks(pend, b)
            fresh = arrived_bits & ~seen_b
            seen_pieces.append(seen_b | fresh)
            pend_pieces.append(pend_b | fresh)

            # merge [K existing + 2 new] candidates, keep top-K by score
            c_key = proto["cand_key"].reshape(r, n, L - 1, K)[:, :, sl, :]
            c_pk = proto["cand_pk"].reshape(r, n, L - 1, K)[:, :, sl, :]
            c_sig = self._sig_view(proto, i, K, prefix="cand_sig")

            all_key = torch.cat([c_key, torch.where(due, rel, INT32_MAX)], dim=-1)
            all_pk = torch.cat([c_pk, pk_new], dim=-1)
            all_sig = torch.cat([c_sig, sig_new], dim=-2)
            valid = all_key != INT32_MAX

            # prefix-carrying candidates are full-block in this level, so
            # the exact evaluateSig on block content scores them correctly
            score, _ = self._eval_sig(
                all_sig, self._blocks(ver, b), self._blocks(indiv, b), bs, lv
            )
            score = torch.where(valid, score, -1)
            # drop worthless entries (checkSigs' iterator remove, :532-537)
            score = torch.where(score == 0, -1, score)

            # jnp.argsort is stable: ties keep slot order
            order = torch.sort(-score, dim=-1, stable=True).indices[..., :K]
            top_ok = torch.gather(score, -1, order) > 0
            sel_key = torch.where(top_ok, torch.gather(all_key, -1, order), INT32_MAX)
            sel_pk = torch.gather(all_pk, -1, order)
            sel_sig = torch.gather(all_sig, -2, order[..., None].expand(order.shape + (b.w_pad,)))

            key_pieces.append(sel_key)
            pk_pieces.append(sel_pk)
            cand_sig_updates[f"cand_sig{i}"] = sel_sig.reshape(r, n, b.nl * K * b.w_pad)

        def flat(ps):
            return torch.cat(ps, dim=2).reshape(r, n, (L - 1) * K)

        return state._replace(
            proto=dict(
                proto,
                in_key=torch.where(due_all, empty_tpl, in_key),
                cand_key=flat(key_pieces),
                cand_pk=flat(pk_pieces),
                pend_ind=self._assemble(pend, pend_pieces),
                ind_seen=self._assemble(seen, seen_pieces),
                **cand_sig_updates,
            )
        )

    # -- tick phase 3: periodic dissemination --------------------------------
    def _dissemination(self, net, state, t: int):
        """doCycle over started levels with send budgets
        (GSFSignature.java:289-343), all levels in ONE stacked send."""
        p = self.params
        proto = state.proto
        n, L = self.n_nodes, self.n_levels
        dev = state.done_at.device
        r = state.done_at.shape[0]
        ids = torch.arange(n, dtype=torch.int32, device=dev)
        lv_all = self._tab("lv_all", dev)
        bs_all = self._tab("lv_bs", dev)

        # t >= 1 first, so the remainder is a floor and a truncated one alike
        on_beat = t >= 1 and (t - 1) % p.period_duration_ms == 0
        may_send = ~state.down if on_beat else torch.zeros_like(state.down)

        k = self._prefix_k(proto["ver"])
        havings = proto["ver"] | self._prefix_interval(k)
        complete = self._level_stats(
            [
                popcount_words(self._lows(havings, b)) >= self._tab(f"b{i}_bs", dev)
                for i, b in enumerate(self.buckets)
            ]
        )
        started = (t >= lv_all * p.timeout_per_level_ms) | complete
        remaining = proto["remaining"][..., 1:]
        mask = may_send[..., None] & started & (remaining > 0)  # [R, N, L-1]

        offset = hash32(state.seed[:, None, None], ids[:, None], lv_all) & (bs_all - 1)
        pos = proto["pos"][..., 1:]
        rel = bs_all + ((pos + offset) & (bs_all - 1))
        new_pos = torch.cat([proto["pos"][..., :1], torch.where(mask, pos + 1, pos)], dim=-1)
        new_remaining = torch.cat(
            [proto["remaining"][..., :1], remaining - mask.to(torch.int32)], dim=-1
        )
        state = state._replace(proto=dict(proto, pos=new_pos, remaining=new_remaining))

        content = [
            self._full_width(self._lows(havings, b), b).reshape(r, n * (L - 1), b.w_pad)
            for b in self.buckets
        ]
        return self._send_stacked(
            net,
            state,
            t,
            mask.reshape(r, -1),
            torch.repeat_interleave(ids, L - 1),
            (ids[:, None] ^ rel).reshape(r, -1),
            lv_all.repeat(n).expand(r, n * (L - 1)),
            content,
            aux=torch.repeat_interleave(k, L - 1, dim=1),
        )

    # -- tick phase 4: start verifications (checkSigs) -----------------------
    def _select(self, net, state, t: int, view=None):
        """Global best-scored candidate across levels
        (GSFSignature.java:524-558).  `view` holds the BOUNDARY state —
        candidates, pending individuals and aggregates as of the end of
        the previous tick (the JAX package's _select docstring explains
        why); write-backs are compare-and-clear by (key, cardinality)
        entry identity against the current slots, and bit-clear merges."""
        proto = state.proto
        v = proto if view is None else {**proto, **view}
        n, L, K = self.n_nodes, self.n_levels, self.CAND_SLOTS
        dev = state.done_at.device
        r = state.done_at.shape[0]

        free = ~proto["ver_active"] & ~state.down
        if t < 1:
            free = torch.zeros_like(free)
        ver, indiv, pend = v["ver"], v["indiv"], v["pend_ind"]

        score_p, rel_p, pk_p, kidx_p = [], [], [], []
        key_pieces, pend_pieces, vcard_pieces, ccard_pieces = [], [], [], []
        for i, b in enumerate(self.buckets):
            sl = slice(b.lo - 1, b.hi)
            lv = self._tab(f"b{i}_lv", dev)
            bs = self._tab(f"b{i}_bs", dev)
            c_key = v["cand_key"].reshape(r, n, L - 1, K)[:, :, sl, :]
            c_pk = v["cand_pk"].reshape(r, n, L - 1, K)[:, :, sl, :]
            c_sig = self._sig_view(v, i, K, prefix="cand_sig")
            valid = c_key != INT32_MAX
            ver_b = self._blocks(ver, b)
            indiv_b = self._blocks(indiv, b)
            score, c_card = self._eval_sig(c_sig, ver_b, indiv_b, bs[:, None], lv[:, None])
            score = torch.where(valid, score, -1)
            # curation: drop worthless entries permanently (condemn mask,
            # applied by entry identity below)
            key_pieces.append(valid & (score == 0))
            vcard_pieces.append(c_card)
            ccard_pieces.append(popcount_words(self._sig_view(proto, i, K, prefix="cand_sig")))
            kbest = torch.argmax(score, dim=-1)
            sbest = torch.gather(score, -1, kbest[..., None])[..., 0]

            # individual pending representative: lowest pending bit
            pend_b = self._blocks(pend, b)
            has_pend = popcount_words(pend_b) > 0
            m_ind = self._lowest_bit(pend_b)
            oh = self._onehot(m_ind & (bs - 1), b.w_pad)
            s_ind = self._eval_sig(oh[..., None, :], ver_b, indiv_b, bs[:, None], lv[:, None])[0]
            s_ind = torch.where(has_pend, s_ind[..., 0], -1)
            # worthless individuals are dropped too
            pend_pieces.append(
                torch.where((has_pend & (s_ind == 0))[..., None], pend_b & ~oh, pend_b)
            )

            use_ind = s_ind > sbest
            score_p.append(torch.maximum(sbest, s_ind))
            rel_p.append(
                torch.where(
                    use_ind,
                    bs + (m_ind & (bs - 1)),
                    torch.gather(c_key, -1, kbest[..., None])[..., 0],
                )
            )
            pk_p.append(
                torch.where(use_ind, 0, torch.gather(c_pk, -1, kbest[..., None])[..., 0])
            )
            kidx_p.append(torch.where(use_ind, -1, kbest.to(torch.int32)))

        l_score = self._level_stats(score_p)  # [R, N, L-1]
        l_rel = self._level_stats(rel_p)
        l_pk = self._level_stats(pk_p)
        l_kidx = self._level_stats(kidx_p)
        # pend writes are pure bit-CLEARS on the view: merge as a clear
        # mask onto the current array (a bit deliver(t) set stays set)
        pend_after_view = self._assemble(pend, pend_pieces)
        pend_clear = v["pend_ind"] & ~pend_after_view
        pend = proto["pend_ind"] & ~pend_clear
        # curation removal by (key, cardinality) ENTRY IDENTITY matched
        # against any current slot of the level
        condemn3 = torch.cat(key_pieces, dim=2)  # [R, N, L-1, K]
        vkey3 = v["cand_key"].reshape(r, n, L - 1, K)
        vcard3 = torch.cat(vcard_pieces, dim=2)
        ckey3 = proto["cand_key"].reshape(r, n, L - 1, K)
        ccard3 = torch.cat(ccard_pieces, dim=2)
        cleared = self._entry_clear(ckey3, ccard3, vkey3, vcard3, condemn3)
        new_key3 = torch.where(cleared, INT32_MAX, ckey3)

        # global best across levels; ascending-level iteration with strict >
        # in the original = first maximum wins = argmax
        lidx = torch.argmax(l_score, dim=-1)[..., None]
        best_score = torch.gather(l_score, -1, lidx)[..., 0]
        best_level = (lidx[..., 0] + 1).to(torch.int32)
        best_rel = torch.gather(l_rel, -1, lidx)[..., 0]
        best_pk = torch.gather(l_pk, -1, lidx)[..., 0]
        best_kidx = torch.gather(l_kidx, -1, lidx)[..., 0]

        can = free & (best_score > 0)
        sel_single = best_kidx < 0

        # load the chosen sig into the verification register
        bs_sel = self._tab("lv_bs", dev)[torch.clamp(best_level - 1, min=0).to(torch.int64)]
        ver_sig = proto["ver_sig"]
        safe_k = torch.clamp(best_kidx, min=0).to(torch.int64)
        for i, b in enumerate(self.buckets):
            m = can & (best_level >= b.lo) & (best_level <= b.hi)
            c_sig = self._sig_view(v, i, K, prefix="cand_sig")
            li = torch.clamp(best_level - b.lo, 0, b.nl - 1).to(torch.int64)
            c_lv = torch.gather(
                c_sig, 2, li[..., None, None, None].expand(r, n, 1, K, b.w_pad)
            )[:, :, 0]  # [R, N, K, w_pad]
            from_buf = torch.gather(c_lv, 2, safe_k[..., None, None].expand(r, n, 1, b.w_pad))[
                :, :, 0
            ]
            single = self._onehot(best_rel & (bs_sel - 1), b.w_pad)
            sig_l = torch.where(sel_single[..., None], single, from_buf)
            if b.w_pad < self.w_max:
                sig_l = torch.cat([sig_l, sig_l.new_zeros((r, n, self.w_max - b.w_pad))], -1)
            ver_sig = torch.where(m[..., None], sig_l, ver_sig)

        # clear the individual pending bit on selection (bit best_rel of the
        # full-width rel-space vector)
        oh_full = self._onehot(best_rel, self.n_words)
        pend = torch.where((can & sel_single)[..., None], pend & ~oh_full, pend)

        # remove the chosen buffer candidate by (key, cardinality) entry
        # identity against the chosen level's CURRENT slots
        lvl_idx = torch.clamp(best_level - 1, min=0)
        vcard_lv = torch.gather(
            vcard3, 2, lvl_idx.to(torch.int64)[..., None, None].expand(r, n, 1, K)
        )[:, :, 0]
        sel_card = torch.gather(vcard_lv, -1, safe_k[..., None])[..., 0]
        remove = can & ~sel_single
        new_key3 = self._remove_chosen(new_key3, ccard3, lvl_idx, best_rel, sel_card, remove)

        return state._replace(
            proto=dict(
                proto,
                cand_key=new_key3.reshape(r, n, (L - 1) * K),
                pend_ind=pend,
                ver_active=torch.where(can, True, proto["ver_active"]),
                ver_done_t=torch.where(can, t + proto["pairing"], proto["ver_done_t"]),
                ver_level=torch.where(can, best_level, proto["ver_level"]),
                ver_rel=torch.where(can, best_rel, proto["ver_rel"]),
                ver_pk=torch.where(can, best_pk, proto["ver_pk"]),
                ver_single=torch.where(can, sel_single, proto["ver_single"]),
                ver_sig=ver_sig,
                sig_checked=proto["sig_checked"] + can.to(torch.int32),
            )
        )

    # -- engine hooks --------------------------------------------------------
    def tick(self, net, state, t: int):
        # boundary-view selection: checkSigs is a conditional task fired at
        # the ms boundary, so it sees candidates, pending individuals and
        # aggregates as of the END of the previous tick
        pre_cand = {
            k: state.proto[k]
            for k in ("cand_key", "cand_pk", "pend_ind")
            + tuple(f"cand_sig{i}" for i in range(len(self.buckets)))
        }
        state = self._channel_deliver(net, state, t)
        pre_merge = {k: state.proto[k] for k in ("ver", "indiv")}
        state = self._commit(net, state, t)
        return self._select(net, state, t, view={**pre_cand, **pre_merge})

    def all_done(self, state):
        """bool[R]: every live node of the replica has aggregated."""
        return torch.all(state.down | (state.done_at > 0), dim=-1)


def make_gsf(
    params: Optional[GSFSignatureParameters] = None,
    capacity: int = 8,  # generic store unused by this protocol
    seed: int = 0,
    device=None,  # None = CUDA; "cpu" runs the plain versions
):
    """Host-side construction mirroring GSFSignature.init: the same
    JavaRandom stream for node building and the down-node draw; returns
    (net, single-replica state)."""
    dev = resolve_device(device)
    params = params or GSFSignatureParameters()
    n = params.node_count
    nb = registry_node_builders.get_by_name(params.node_builder_name)
    latency = registry_network_latencies.get_by_name(params.network_latency_name)
    rd = JavaRandom(0)

    nodes = [Node(rd, nb) for _ in range(n)]
    # node 1 kept up to help debugging (GSFSignature.java:621)
    bad = choose_bad_nodes(rd, n, params.nodes_down)
    down = np.array([i in bad for i in range(n)])

    pairing = np.maximum(
        1, (params.pairing_time * np.array([nd.speed_ratio for nd in nodes]))
    ).astype(np.int32)

    proto = BatchedGSF(params)
    # dissemination fires at t >= 1 with (t - 1) % period == 0
    proto.BEAT_PERIOD = params.period_duration_ms
    proto.BEAT_RESIDUES = (1 % params.period_duration_ms,)
    cols = build_node_columns(nodes, getattr(latency, "city_index", None))
    # flat mode: aggregation messaging bypasses the generic store entirely
    net = BatchedNetwork(proto, latency, n, capacity=capacity, wheel_rows=0, device=dev)
    state = net.init_state(
        cols, seed=seed, proto=proto.proto_init(n, pairing, device=dev), down=down
    )
    return net, state
