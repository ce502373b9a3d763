"""Batched HandelEth2: multi-height Handel aggregation, ported to PyTorch.

A method-for-method port of the JAX package's
protocols/handeleth2_batched.py — its module docstring gives the model in
full (three concurrent processes on a rotating slot axis P = 3, a dense
hash axis H = 8 of packed who-bitsets `[N, P, L, H, W]`, the prefix merge
of updateAllOutgoing, one verification core per node selecting by
sizeIfMerged, the K-slot to-verify buffer, the emission-rank cursor
walk).  What changes here is representation only:

  * every tensor carries the replica axis R in front ([R, N, ...]);
    packed uint32 words are int32 bit views;
  * the clock `t` is the engine's host int, and so are the beats' tests:
    each node's start/stop, dissemination and verify beats depend on its
    static start offset and pairing time only, so a phase none of whose
    beats fires at `t` is not formed (its emissions still take their send
    counters).  `_select`'s purge of the to-verify buffer is not behind a
    beat and runs every tick;
  * the per-level loops of `_dissemination` (P * (L-1) single sends) and
    of the fastPath (the L-3 bursts of `_commit`) touch disjoint
    (process, level) cells and read only state the loop does not write,
    so each runs as one vectorized pass; `_next_peer` finds the j-th
    eligible peer of the rotated walk by sorting the peers' offsets from
    the cursor, where the JAX package takes a cumulative sum per j;
  * emissions carry only their live rows (one device read sizes them; a
    masked row changes no state), and an emission with none goes out
    with no rows, keeping its send counter; delivery runs on the view's
    delivered rows only;
  * the sizeIfMerged popcounts are fused: |cand|, [inc & cand != 0] and
    |ind | cand| per candidate hash row come from `popcount_words` and
    two `popcount_binop` launches that read the node's rows in place,
    without forming their K-fold broadcast (one `cand_score` pass needs
    the candidates copied hash-major first, and measured slower on the
    H100, PERF.md); `_commit`'s merge counts with `popcount_binop`
    likewise;
  * `.at[].max` on words is an unsigned max, not an OR (`_umax`), as in
    the JAX package: a duplicate destination keeps the larger word.

Every phase is bit-identical to the JAX package
(tests/test_torch_handeleth2.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.node import build_node_columns
from ..core.registries import registry_network_latencies
from ..engine.core import BatchedNetwork, Emission, resolve_device
from ..engine.protocol import BatchedProtocol
from ..engine.rng import to_i32, uniform_u01
from ..ops.bitops import popcount_binop, popcount_words
from ..ops.indexing import live_rows, set_rows
from ..utils.more_math import log2
from .handeleth2 import PERIOD_TIME, HandelEth2Parameters, handeleth2_roles

P = 3  # concurrent processes
H = 8  # hash axis
INT_MAX = 2**31 - 1
_FLIP = -(2**31)  # xor with the sign bit: unsigned order as signed order


def _umax(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise max of int32 bit views as uint32 values."""
    return torch.where((a ^ _FLIP) >= (b ^ _FLIP), a, b)


def _scatter_umax(base: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Functional `base.at[rows].max(vals, mode="drop")` on word rows as
    uint32: base [M, w], rows [Q] in [0, M] (M drops), vals [Q, w].
    Duplicate rows keep their largest word, in any order."""
    ext = torch.cat([base, base[:1]]) ^ _FLIP
    ext.scatter_reduce_(0, rows[:, None].expand(vals.shape), vals ^ _FLIP, "amax")
    return ext[:-1] ^ _FLIP


def _flat_at(x: torch.Tensor, lead: int, idx: torch.Tensor) -> torch.Tensor:
    """x[r, n, idx[r, n, ...]] over x's `lead` axes after [R, N] flattened:
    x [R, N, A1..Alead, ...rest], idx [R, N, ...] flat cell indices into
    A1..Alead -> idx.shape + rest."""
    r, n = x.shape[:2]
    cells = int(np.prod(x.shape[2:2 + lead]))
    rest = x.shape[2 + lead:]
    flat = x.reshape((r * n * cells,) + rest)
    base = torch.arange(r * n, device=x.device).view((r, n) + (1,) * (idx.dim() - 2)) * cells
    return flat[base + idx]


def _flat_set(x: torch.Tensor, lead: int, idx: torch.Tensor, vals: torch.Tensor,
              keep: torch.Tensor) -> torch.Tensor:
    """Functional x[r, n, idx[r, n]] = vals[r, n] where keep[r, n]: idx
    [R, N] cells of x's `lead` axes after [R, N] (one per node, so no
    duplicates); vals [R, N, ...rest]."""
    r, n = x.shape[:2]
    cells = int(np.prod(x.shape[2:2 + lead]))
    rest = x.shape[2 + lead:]
    out = x.reshape((r * n * cells,) + rest).clone()
    pos = (torch.arange(r * n, device=x.device).view(r, n) * cells + idx).reshape(-1)
    kk = keep.reshape((-1,) + (1,) * len(rest))
    out[pos] = torch.where(kk, vals.reshape((-1,) + rest).to(x.dtype), out[pos])
    return out.view(x.shape)


class BatchedHandelEth2(BatchedProtocol):
    MSG_TYPES = ["AGG"]
    TICK_INTERVAL = 1
    CAND_SLOTS = 8
    WORD_LEAVES = ("fin_peers", "inc", "ind", "out", "c_atts", "v_atts")
    PROTO_KEYS = ("fin_peers", "c_atts")

    def __init__(self, params: HandelEth2Parameters, roles: dict, device=None):
        dev = resolve_device(device)
        self.params = params
        self.n_nodes = params.node_count
        self.lc = log2(self.n_nodes)  # levelCount
        self.nl = self.lc + 1  # levels 0..levelCount
        self.nw = max(1, self.n_nodes // 32)
        # payload: height, level, own_hash, level_finished, atts[H*W]
        self.PAYLOAD_WIDTH = 4 + H * self.nw
        self.rr = torch.as_tensor(np.asarray(roles["reception_ranks"], np.int32), device=dev)
        self.peers = torch.as_tensor(np.asarray(roles["peers"], np.int32), device=dev)
        self.pairing = torch.as_tensor(np.asarray(roles["pairing"], np.int32), device=dev)
        delta = np.asarray(roles.get("delta", np.zeros(self.n_nodes, np.int32)), np.int32)
        self.delta = torch.as_tensor(delta, device=dev)
        # host copies for the beat tests
        self._delta_h = delta.astype(np.int64)
        self._pairing_h = np.asarray(roles["pairing"], np.int64)
        lr = np.arange(self.nl)
        self.peers_ct = torch.as_tensor(
            np.where(lr == 0, 1, 1 << np.maximum(lr - 1, 0)).astype(np.int32), device=dev
        )
        self.pow3 = torch.as_tensor([3**i for i in range(10)], dtype=torch.int32, device=dev)

    def msg_size(self, mtype: int) -> int:
        return 1

    def proto_init(self, n_nodes: int, device=None):
        """Protocol state for one replica (no leading replica axis)."""
        dev = resolve_device(device)
        n, nl, nw, k = self.n_nodes, self.nl, self.nw, self.CAND_SLOTS

        def zi(*s, dtype=torch.int32):
            return torch.zeros(s, dtype=dtype, device=dev)

        def full(s, v):
            return torch.full(s, v, dtype=torch.int32, device=dev)

        return {
            "height": zi(n, P),  # 0 = inactive slot
            "own_hash": zi(n, P),
            "start_at": zi(n, P),
            "fin_peers": zi(n, P, nw),
            "rr_bump": zi(n, P, n),
            "inc": zi(n, P, nl, H, nw),
            "ind": zi(n, P, nl, H, nw),
            "out": zi(n, P, nl, H, nw),
            "out_fin": zi(n, P, nl, dtype=torch.bool),
            "last_sent": full((n, P, nl), -1),
            "first_best": full((n, P, nl), -1),
            "contacted": zi(n, P, nl),
            "cycle_ct": zi(n, P, nl),
            "pos": zi(n, P, nl),
            # to-verify buffer
            "c_rank": full((n, P, nl, k), INT_MAX),
            "c_from": zi(n, P, nl, k),
            "c_hash": zi(n, P, nl, k),
            "c_atts": zi(n, P, nl, k, H, nw),
            # shared verification core
            "v_active": zi(n, dtype=torch.bool),
            "v_done_t": zi(n),
            "v_proc": zi(n),
            "v_level": zi(n),
            "v_from": zi(n),
            "v_hash": zi(n),
            "v_height": zi(n),
            "v_atts": zi(n, H, nw),
            "last_vproc_h": zi(n),  # lastVerified process height
            "last_lvl": full((n, P), 2),
            "window": full((n,), 16),
            "agg_done": zi(n),
            "contrib_total": zi(n),
            "next_height": full((n,), 1001),
        }

    # -- helpers -------------------------------------------------------------
    def _onehot_w(self, idx: torch.Tensor) -> torch.Tensor:
        """[...] node ids -> [..., nw] words with bit id % 32 of word id // 32."""
        cols = torch.arange(self.nw, device=idx.device)
        bit = to_i32(torch.ones_like(idx, dtype=torch.int64) << (idx % 32).to(torch.int64))
        return torch.where(cols == (idx // 32)[..., None].to(torch.int64), bit[..., None], 0)

    def _card(self, who: torch.Tensor) -> torch.Tensor:
        """popcount over the (H, W) trailing axes."""
        return popcount_words(who.reshape(who.shape[:-2] + (-1,)))

    def _beats(self, t: int, period) -> bool:
        """Does some node's beat of `period` (an int or per-node array) fire
        at host tick t?  The device masks refine it per node and replica."""
        tb = t - self._delta_h
        return bool(np.any((tb >= 1) & ((tb - 1) % period == 0)))

    def _beat_mask(self, state, t: int, period) -> torch.Tensor:
        """bool[R, N]: live & (tb >= 1) & ((tb - 1) % period == 0)."""
        tb = t - self.delta
        return ~state.down & (tb >= 1) & (torch.fmod(tb - 1, period) == 0)

    def merge_counts(self, inc, ind, cand):
        """Per candidate hash row: (|cand|, [inc & cand != 0], |ind | cand|)
        for inc, ind [..., H, W] node rows and cand [..., K, H, W]
        candidates -> three [..., K, H].  The node rows are read in place,
        broadcast over K."""
        av_c = popcount_words(cand)
        inter = popcount_binop(inc[..., None, :, :], cand, "and") > 0
        merged = popcount_binop(ind[..., None, :, :], cand, "or")
        return av_c, inter, merged

    def _size_if_merged(self, inc, ind, cand):
        """sizeIfMerged (HLevel.java:160-196) of cand [..., K, H, W] against
        the node rows inc, ind [..., H, W] -> [..., K]; with our_c the
        popcount of inc [..., H]."""
        our_c = popcount_words(inc)[..., None, :]
        av_c, inter, merged = self.merge_counts(inc, ind, cand)
        per_hash = torch.where(
            our_c == 0, av_c, torch.where(~inter, our_c + av_c, torch.maximum(merged, our_c))
        )
        # hashes where the candidate has nothing keep our contribution
        per_hash = torch.where(av_c == 0, our_c, per_hash)
        return per_hash.sum(-1).to(torch.int32), our_c[..., 0, :]

    def _next_peer(self, proto, procs, levels, count: int):
        """get_remaining_peers for `count` destinations from each cursor,
        skipping finished peers, over X (process, level) columns: levels
        [X], procs [X] (every node's) or [R, N, X].  Returns (dests
        [R, N, X, count], ok [R, N, X, count], step [R, N, X]).

        The JAX package rotates the node's peer list (cnt peers, padded to
        mp) by the cursor into mp positions, k -> peer (pos + k) % cnt,
        and takes the j-th eligible position by a cumulative sum.  Eligible
        peer e sits at positions o_e + w * cnt (o_e = (e - pos) mod cnt),
        so with the m eligible offsets sorted, the j-th hit is offset
        o_(j % m) of lap j // m, valid while it is below mp."""
        fin_all = proto["fin_peers"]
        r, n = fin_all.shape[:2]
        mp = self.peers.shape[2]
        dev = fin_all.device
        lv = levels.to(torch.int64)
        plist = self.peers[:, lv].unsqueeze(0)  # [1, N, X, mp]
        x = lv.shape[-1]
        if procs.dim() == 1:
            fin = fin_all[:, :, procs.to(torch.int64)]  # [R, N, X, nw]
            cell = (procs.to(torch.int64) * self.nl + lv).expand(r, n, x)
        else:
            fin = _flat_at(fin_all, 1, procs.to(torch.int64))
            cell = procs.to(torch.int64) * self.nl + lv
        pos = _flat_at(proto["pos"], 2, cell)  # [R, N, X]
        cnt = (plist >= 0).sum(-1, keepdim=True).clamp(min=1)
        pv = plist.clamp(0, n - 1).to(torch.int64)
        fword = torch.gather(fin, -1, (pv // 32).expand(r, n, x, mp))
        fbit = (fword >> (pv % 32)) & 1
        eligible = (plist >= 0) & (fbit == 0)
        ar = torch.arange(mp, device=dev)
        off = torch.where(eligible, torch.remainder(ar - pos[..., None], cnt), mp)
        kk = min(count, mp)
        o_sorted, at = torch.topk(off, kk, dim=-1, largest=False, sorted=True)
        peer_sorted = torch.gather(plist.expand(r, n, x, mp), -1, at)
        m = eligible.sum(-1, keepdim=True)  # [R, N, X, 1]
        j = torch.arange(count, device=dev)
        mm = m.clamp(min=1)
        i_j = torch.remainder(j, mm)  # [R, N, X, count]
        k_j = torch.gather(o_sorted, -1, i_j) + torch.div(j, mm, rounding_mode="floor") * cnt
        ok = (m > 0) & (k_j < mp)
        dests = torch.where(ok, torch.gather(peer_sorted, -1, i_j), 0)
        step = torch.where(ok, k_j + 1, 0).amax(-1)
        return dests.to(torch.int32), ok, step.to(torch.int32)

    def _pick(self, x: torch.Tensor, proc, lvl) -> torch.Tensor:
        """x[r, n, proc, lvl] for x [R, N, P, L, ...]; proc an int or [R, N],
        lvl an int or [R, N] -> [R, N, ...]."""
        if isinstance(proc, int) and isinstance(lvl, int):
            return x[:, :, proc, lvl]
        return _flat_at(x, 2, proc * self.nl + lvl)

    @staticmethod
    def _rows_at(x: torch.Tensor, node: torch.Tensor, cell) -> torch.Tensor:
        """x[r, node[r, m], cell[r, m]] for x [R, N, C, ...] (C flattened
        cells after [R, N]; cell an int or [R, M]) -> [R, M, ...]."""
        r, n, c = x.shape[0], x.shape[1], x.shape[2]
        rest = x.shape[3:]
        base = torch.arange(r, device=x.device)[:, None] * n + node
        return x.reshape((r * n * c,) + rest)[base * c + cell]

    def _agg_emissions(self, proto, inc_cmp, out_card, specs):
        """SendAggregation(level, ownHash, levelFinished, outgoing) rows:
        each spec (mask [R, N, d], dests [R, N, d], proc, level) is one
        emission of N * d node-major rows, proc an int or [R, N], level an
        int; inc_cmp and out_card [R, N, P, L] are `_inc_complete` and
        `_card(out)`.  Only the live rows go out — one device read sizes
        every spec — in the JAX package's row order; a spec with none is a
        zero-row emission."""
        out, height, own = proto["out"], proto["height"], proto["own_hash"]
        r, n = height.shape[:2]
        dev = height.device
        masks = [
            (mask & (self._pick(out_card, proc, lvl) > 0)[..., None]).reshape(r, -1)
            for mask, _, proc, lvl in specs
        ]
        ems = []
        for (mask, dests, proc, lvl), rows in zip(specs, live_rows(masks)):
            d = mask.shape[-1]
            if rows is None:
                ems += self._no_emissions(r, dev, 1)
                continue
            idx, live = rows
            node = torch.div(idx, d, rounding_mode="floor")  # [R, M]
            procn = proc if isinstance(proc, int) else torch.gather(proc, 1, node)
            cell = procn * self.nl + lvl
            outp = out.reshape((r, n, P * self.nl) + out.shape[4:])
            cols = [
                self._rows_at(height, node, procn)[..., None],
                torch.full_like(node, lvl)[..., None],
                self._rows_at(own, node, procn)[..., None],
                self._rows_at(inc_cmp.reshape(r, n, -1), node, cell)[..., None],
                self._rows_at(outp, node, cell).reshape(r, -1, H * self.nw),
            ]
            payload = torch.cat([c.to(torch.int32) for c in cols], dim=-1)
            ems.append(Emission(
                mask=live,
                from_idx=node.to(torch.int32),
                to_idx=torch.gather(dests.reshape(r, -1), 1, idx).clamp(0, n - 1),
                mtype=self.mtype("AGG"),
                payload=payload,
            ))
        return ems

    def _inc_complete(self, proto) -> torch.Tensor:
        return self._card(proto["inc"]) == self.peers_ct

    def _is_open(self, proto, now: int, out_card: torch.Tensor) -> torch.Tensor:
        """isOpen per (R, N, P, L) (HLevel.java:106-117); out_card is
        _card(out)."""
        lr = torch.arange(self.nl, dtype=torch.int32, device=out_card.device)
        elapsed = proto["start_at"][..., None]
        return ~proto["out_fin"] & (
            (now - elapsed >= (lr - 1) * self.params.level_wait_time)
            | (out_card == self.peers_ct)
        ) & (proto["height"][..., None] > 0) & (lr > 0)

    def _update_all_outgoing(self, proto, mask: torch.Tensor, now: int):
        """Prefix merge over levels for OPEN levels (HNode.java:208-231);
        mask [R, N, P] selects the processes to refresh: out[l] = the union
        of incoming[0..l-1]."""
        inc = proto["inc"]  # [R, N, P, L, H, W]
        acc = torch.zeros_like(inc[:, :, :, 0])
        shifted = []
        for l in range(self.nl):
            shifted.append(acc)
            acc = acc | inc[:, :, :, l]
        shifted = torch.stack(shifted, dim=3)
        out = proto["out"]
        upd = mask[..., None] & self._is_open(proto, now, self._card(out))
        proto["out"] = torch.where(upd[..., None, None], shifted, out)
        return proto

    # -- per-tick ------------------------------------------------------------
    def tick(self, net, state, t: int):
        # ---- 1. verification commits (update at t = beat + pairing - 1) ---
        proto = dict(state.proto)
        proto, ems = self._commit(state, proto, t)
        return net.apply_emissions(state._replace(proto=proto), ems, t)

    def tick_beat(self, net, state, t: int):
        """Sparse periodic phases: the process start/stop beat (every
        PERIOD_TIME) and the dissemination beat (every period_duration_ms),
        each node on its own shifted clock t - delta."""
        proto = dict(state.proto)
        # ---- 2. process start/stop beat ------------------------------------
        if self._beats(t, PERIOD_TIME):
            proto = self._start_stop(state, proto, self._beat_mask(state, t, PERIOD_TIME), t)
        # ---- 3. dissemination beat -----------------------------------------
        proto, ems = self._dissemination(state, proto, t)
        return net.apply_emissions(state._replace(proto=proto), ems, t)

    def tick_post(self, net, state, t: int):
        # ---- 4. verify beat (every nodePairingTime, per node) --------------
        proto = self._select(state, dict(state.proto), t)
        return state._replace(proto=proto)

    def _start_stop(self, state, proto, beat: torch.Tensor, t: int):
        """startNewAggregation + the expiring slot's stopAggregation
        (HNode.java:111-145, 468-486): every beating node resets slot
        next_height % P for its new height."""
        nl, nw = self.nl, self.nw
        dev = beat.device
        r, n = beat.shape
        ids = torch.arange(n, dtype=torch.int32, device=dev)
        h_new = proto["next_height"]
        slot = torch.remainder(h_new, P)
        at = beat[..., None] & (torch.arange(P, device=dev) == slot[..., None])  # [R, N, P]
        old_h = torch.gather(proto["height"], 2, slot[..., None].to(torch.int64))[..., 0]
        stopping = beat & (old_h > 0)
        # contributionsTotal += last level's incoming+outgoing cardinality
        best = self._card(self._pick(proto["inc"], slot, nl - 1)) + self._card(
            self._pick(proto["out"], slot, nl - 1)
        )
        proto["contrib_total"] = proto["contrib_total"] + torch.where(stopping, best, 0)
        proto["agg_done"] = proto["agg_done"] + stopping.to(torch.int32)

        # own hash: geometric (80% h=0) from the counter RNG
        hsh = torch.zeros((r, n), dtype=torch.int32, device=dev)
        cont = torch.ones((r, n), dtype=torch.bool, device=dev)
        seed = state.seed[:, None]
        for j in range(H - 1):
            u = uniform_u01(seed, 0xE717, ids, h_new, j)
            cont = cont & (u < torch.tensor(0.2, dtype=torch.float32))
            hsh = hsh + cont.to(torch.int32)

        def slot_set(name, new_val):
            x = proto[name]
            m = at.view(at.shape + (1,) * (x.dim() - 3))
            proto[name] = torch.where(m, torch.as_tensor(new_val, dtype=x.dtype, device=dev), x)

        slot_set("height", h_new[..., None])
        slot_set("own_hash", hsh[..., None])
        slot_set("start_at", t)
        slot_set("fin_peers", 0)
        slot_set("rr_bump", 0)
        # level 0 holds the node's own attestation under its hash
        lr = torch.arange(nl, device=dev)
        hr = torch.arange(H, device=dev)
        own0 = (lr == 0).view(nl, 1, 1) & (hr.view(H, 1) == hsh[..., None, None, None])
        inc0 = torch.where(own0, self._onehot_w(ids).view(n, 1, 1, nw), 0).unsqueeze(2)
        slot_set("inc", inc0)
        slot_set("ind", inc0)
        slot_set("out", 0)
        slot_set("out_fin", (lr == 0))
        slot_set("last_sent", -1)
        slot_set("first_best", -1)
        slot_set("contacted", 0)
        slot_set("cycle_ct", 0)
        slot_set("pos", 0)
        slot_set("c_rank", INT_MAX)
        slot_set("last_lvl", 2)
        proto["next_height"] = torch.where(beat, h_new + 1, h_new)
        return proto

    def _dissemination(self, state, proto, t: int):
        """doCycle over open levels of every live process
        (HNode.java:440-445, HLevel.java:80-93): one single-destination
        send per (process, level >= 1), P * (L-1) emissions in
        process-major order."""
        nl = self.nl
        r, n = state.down.shape
        dev = state.down.device
        specs_p = [(pi, l) for pi in range(P) for l in range(1, nl)]
        if not self._beats(t, self.params.period_duration_ms):
            return proto, self._no_emissions(r, dev, len(specs_p))
        beat = self._beat_mask(state, t, self.params.period_duration_ms)
        proto = self._update_all_outgoing(proto, beat[..., None] & (proto["height"] > 0), t)
        out_card = self._card(proto["out"])
        is_open = self._is_open(proto, t, out_card)
        proto["cycle_ct"] = proto["cycle_ct"] + (beat[..., None, None] & is_open).to(torch.int32)
        m = torch.div(proto["contacted"], self.lc, rounding_mode="floor")
        period = self.pow3[m.clamp(0, 9).to(torch.int64)]
        fire = beat[..., None, None] & is_open & (torch.fmod(proto["cycle_ct"], period) == 0)

        # every (process, level >= 1) cell at once: the JAX loop's cells
        # are disjoint and its reads are not written inside it
        procs = torch.arange(P, device=dev).repeat_interleave(nl - 1)
        levels = torch.arange(1, nl, device=dev).repeat(P)
        dest, ok, step = self._next_peer(proto, procs, levels, 1)
        sh = (r, n, P, nl - 1)
        d0 = dest[..., 0].view(sh)
        step = step.view(sh)
        send0 = ok[..., 0].view(sh) & fire[..., 1:]
        card = out_card[..., 1:]
        last_sent, first_best = proto["last_sent"][..., 1:], proto["first_best"][..., 1:]
        # loop detection: same content to the same first peer
        send = send0 & ~((card == last_sent) & (d0 == first_best))
        newbest = send & (card > last_sent)

        def upd(name, vals):
            proto[name] = torch.cat([proto[name][..., :1], vals], dim=-1)

        upd("pos", proto["pos"][..., 1:] + torch.where(send, step, 0))
        upd("contacted", proto["contacted"][..., 1:] + send.to(torch.int32))
        upd("first_best", torch.where(newbest, d0, first_best))
        upd("last_sent", torch.where(newbest, card, last_sent))
        inc_cmp = self._inc_complete(proto)
        specs = [
            (send[:, :, pi, l - 1, None], d0[:, :, pi, l - 1, None], pi, l)
            for pi, l in specs_p
        ]
        return proto, self._agg_emissions(proto, inc_cmp, out_card, specs)

    def _no_emissions(self, r: int, dev, count: int):
        """`count` AGG emissions without rows (each takes a send counter)."""
        return [Emission.no_rows(r, self.mtype("AGG"), self.PAYLOAD_WIDTH, dev)] * count

    # -- arrivals (onNewAgg, HNode.java:317-349) ----------------------------
    def deliver(self, net, state, deliver_mask, t: int):
        """Every delivered row: finished-level bits, the reception-rank
        bump, and the to-verify buffer insert (one winner per (node,
        process, level) a tick: the lowest ring slot)."""
        proto = dict(state.proto)
        n, nl, nw, k = self.n_nodes, self.nl, self.nw, self.CAND_SLOTS
        r, dv = deliver_mask.shape
        # only the delivered rows of the view do anything: one device read
        sel = deliver_mask.reshape(-1).nonzero().squeeze(1)
        if sel.numel() == 0:
            return state, []
        to = state.msg_to.reshape(-1)[sel].to(torch.int64)
        frm = state.msg_from.reshape(-1)[sel].to(torch.int64)
        pay = state.msg_payload.reshape(r * dv, -1)[sel]
        mh = pay[:, 0]
        ml = pay[:, 1].clamp(0, nl - 1).to(torch.int64)
        mhash = pay[:, 2].clamp(0, H - 1)
        mfin = pay[:, 3] == 1
        slot = torch.remainder(mh, P).to(torch.int64)
        node = torch.div(sel, dv, rounding_mode="floor") * n + to  # flat (replica, node)
        ns = node * P + slot  # flat (replica, node, process)
        ok = (proto["height"].reshape(-1)[ns] == mh) & (mh > 0)

        # levelFinished -> finished_peers bit: an unsigned max, as JAX's
        # .at[].max on uint32 words (not an OR)
        trash = r * n * P
        proto["fin_peers"] = _scatter_umax(
            proto["fin_peers"].reshape(trash, nw), torch.where(ok & mfin, ns, trash),
            self._onehot_w(frm),
        ).view(proto["fin_peers"].shape)

        # reception rank, then bump (HNode.java:338-341); repeated
        # (to, slot, frm) rows of one tick accumulate
        rb = proto["rr_bump"].reshape(-1)
        rank = self.rr[to, frm] + rb[ns * n + frm] * n
        rb = torch.cat([rb, rb.new_zeros(1)]).scatter_add(
            0, torch.where(ok, ns * n + frm, rb.numel()), torch.ones_like(rank)
        )
        proto["rr_bump"] = rb[:-1].view(proto["rr_bump"].shape)

        # insert into the to-verify buffer unless the level is complete;
        # winner per (node, process, level): the lowest ring slot
        key = ns * nl + ml
        want = ok & ~self._inc_complete(proto).reshape(-1)[key]
        cells = r * n * P * nl
        win = torch.full((cells + 1,), r * dv, dtype=torch.int64, device=sel.device)
        win = win.scatter_reduce(0, torch.where(want, key, cells), sel, "amin")
        is_win = want & (win[key] == sel)
        # worst existing buffer slot by rank (the first max); replace if
        # empty or worse
        crank = proto["c_rank"].reshape(cells, k)[key]
        worst = torch.argmax(crank, dim=1)
        worst_rank = torch.gather(crank, 1, worst[:, None])[:, 0]
        do_ins = is_win & (rank < worst_rank)
        cell = (key * k + worst)[:, None]
        proto["c_rank"] = set_rows(proto["c_rank"], cell, rank[:, None], do_ins)
        proto["c_from"] = set_rows(proto["c_from"], cell, frm[:, None], do_ins)
        proto["c_hash"] = set_rows(proto["c_hash"], cell, mhash[:, None], do_ins)
        hw = H * nw
        proto["c_atts"] = set_rows(
            proto["c_atts"], cell * hw + torch.arange(hw, device=sel.device), pay[:, 4:4 + hw],
            do_ins,
        )
        return state._replace(proto=proto), []

    # -- verification core ---------------------------------------------------
    def _select(self, state, proto, t: int):
        """The purge of the to-verify buffer (every tick), then on verify
        beats verify (HNode.java:262-287) + bestToVerify (:148-175):
        next-height process first, else min height; level 1 first, then
        the cycling level cursor."""
        nl, k = self.nl, self.CAND_SLOTS
        r, n = state.down.shape
        dev = state.down.device
        inc = proto["inc"]

        # candidate scores per (process, level, slot), curated
        valid = proto["c_rank"] < INT_MAX
        scores, our_c = self._size_if_merged(inc, proto["ind"], proto["c_atts"])
        cur_card = our_c.sum(-1).to(torch.int32)  # _card(inc): [R, N, P, L]
        inc_c = cur_card == self.peers_ct
        keep = valid & (scores > cur_card[..., None]) & ~inc_c[..., None]
        # purge: completed levels clear their buffers; non-improving drop
        proto["c_rank"] = torch.where(keep, proto["c_rank"], INT_MAX)
        if not self._beats(t, self._pairing_h):
            return proto
        beat = self._beat_mask(state, t, self.pairing)
        free = beat & ~proto["v_active"] & torch.any(proto["height"] > 0, dim=-1)

        # best slot per (process, level) by score (the first max)
        kept = torch.where(keep, scores, -1)
        sl_best = torch.argmax(kept, dim=-1)
        sl_score = torch.gather(kept, -1, sl_best[..., None])[..., 0]
        has = sl_score > 0  # [R, N, P, L]

        # the process: lastVerified.height + 1 if it has work, else the
        # minimum active height
        hts = proto["height"]
        has_proc = torch.any(has, dim=-1)
        next_h = proto["last_vproc_h"] + 1
        is_next = (hts == next_h[..., None]) & (hts > 0) & has_proc
        minh = torch.where((hts > 0) & has_proc, hts, 2**30).amin(-1)
        is_min = (hts == minh[..., None]) & has_proc
        pick = torch.where(torch.any(is_next, dim=-1, keepdim=True), is_next, is_min)
        proc_sel = torch.argmax(pick.to(torch.uint8), dim=-1)  # the first
        proc_ok = torch.any(pick, dim=-1) & free

        # level: 1 first, else cycle from last_lvl (:148-175)
        has_p = _flat_at(has, 1, proc_sel)  # [R, N, L]
        lvl1 = has_p[..., 1] if nl > 1 else torch.zeros_like(free)
        last_lvl_p = torch.gather(proto["last_lvl"], 2, proc_sel[..., None])[..., 0]
        start = last_lvl_p.clamp(2, nl - 1)
        offs = torch.arange(nl, dtype=torch.int32, device=dev)
        rot = (2 + torch.fmod(start[..., None] - 2 + offs, max(1, nl - 2))).clamp(0, nl - 1)
        rot_has = torch.gather(has_p, 2, rot.to(torch.int64))
        first = torch.argmax(rot_has.to(torch.uint8), dim=-1)
        lvl_cyc = torch.gather(rot, 2, first[..., None])[..., 0]
        lvl_sel = torch.where(lvl1, 1, lvl_cyc).to(torch.int64)
        go = proc_ok & (lvl1 | torch.any(rot_has, dim=-1))

        cellpl = proc_sel * nl + lvl_sel
        ks = torch.gather(sl_best.reshape(r, n, -1), 2, cellpl[..., None])[..., 0]
        cellk = cellpl * k + ks
        h_sel = torch.gather(hts, 2, proc_sel[..., None])[..., 0]
        proto["last_vproc_h"] = torch.where(go, h_sel, proto["last_vproc_h"])
        proto["last_lvl"] = _flat_set(proto["last_lvl"], 1, proc_sel, lvl_sel, go & ~lvl1)
        proto["v_active"] = proto["v_active"] | go
        proto["v_done_t"] = torch.where(go, t + self.pairing - 1, proto["v_done_t"])
        proto["v_proc"] = torch.where(go, proc_sel.to(torch.int32), proto["v_proc"])
        proto["v_level"] = torch.where(go, lvl_sel.to(torch.int32), proto["v_level"])
        proto["v_from"] = torch.where(go, _flat_at(proto["c_from"], 3, cellk), proto["v_from"])
        proto["v_hash"] = torch.where(go, _flat_at(proto["c_hash"], 3, cellk), proto["v_hash"])
        proto["v_height"] = torch.where(go, h_sel, proto["v_height"])
        proto["v_atts"] = torch.where(
            go[..., None, None], _flat_at(proto["c_atts"], 3, cellk), proto["v_atts"]
        )
        # consume the buffer slot
        proto["c_rank"] = _flat_set(proto["c_rank"], 3, cellk, torch.full_like(ks, INT_MAX), go)
        return proto

    def _merge(self, inc_l, ind_l, cand, v_hash, v_from):
        """The verified candidate into the level (inc_l, ind_l, cand [R, N,
        H, W]): merge_incoming per hash (HLevel.java:228-262) and the
        sender's individual bit under v_hash.  Returns (new_inc, new_ind)."""
        our_c = popcount_words(inc_l)
        av_c = popcount_words(cand)
        inter = popcount_binop(inc_l, cand, "and") > 0
        use_cand = (our_c == 0) | ~inter
        grow = popcount_binop(ind_l, cand, "or") > our_c
        new_inc = torch.where(
            (av_c > 0)[..., None],
            torch.where(
                use_cand[..., None],
                inc_l | cand,
                torch.where(grow[..., None], ind_l | cand, inc_l),
            ),
            inc_l,
        )
        # .at[n, v_hash].max(onehot): an unsigned max on the word, not an OR
        hsel = torch.arange(H, device=cand.device) == v_hash[..., None]  # [R, N, H]
        new_ind = torch.where(hsel[..., None], _umax(ind_l, self._onehot_w(v_from)[..., None, :]),
                              ind_l)
        return new_inc, new_ind

    def _commit(self, state, proto, t: int):
        """updateVerifiedSignatures (HNode.java:181-205): merge, window
        growth, fastPath on level completion."""
        nl, lc = self.nl, self.lc
        r, n = state.down.shape
        dev = state.down.device
        due = proto["v_active"] & (t >= proto["v_done_t"])
        pi = proto["v_proc"].to(torch.int64)
        l = proto["v_level"].to(torch.int64)
        # the slot may have rotated to the NEXT height since selection —
        # match the height captured at selection, not just slot liveness
        h_pi = torch.gather(proto["height"], 2, pi[..., None])[..., 0]
        still = due & (h_pi == proto["v_height"]) & (proto["v_height"] > 0)
        proto["v_active"] = proto["v_active"] & ~due
        lus = list(range(2, nl - 1))
        # one device read: does any node commit this tick?
        if not bool(still.any()):
            return proto, self._no_emissions(r, dev, len(lus))

        new_inc, new_ind = self._merge(
            self._pick(proto["inc"], pi, l), self._pick(proto["ind"], pi, l), proto["v_atts"],
            proto["v_hash"], proto["v_from"],
        )
        cell = pi * nl + l
        proto["inc"] = _flat_set(proto["inc"], 2, cell, new_inc, still)
        proto["ind"] = _flat_set(proto["ind"], 2, cell, new_ind, still)
        proto["window"] = torch.where(
            still, torch.clamp(proto["window"] * 2, max=128), proto["window"]
        )

        # fastPath: completing a level bursts the now-complete outgoing of
        # HIGHER levels to levelCount peers each (HNode.java:195-203; the
        # top level is excluded by the reference's bound, kept bug-for-bug)
        refresh = still[..., None] & (torch.arange(P, device=dev) == pi[..., None])
        proto = self._update_all_outgoing(proto, refresh, t)
        inc_cmp = self._inc_complete(proto)
        inc_done = _flat_at(inc_cmp, 2, cell) & still & (l < lc)
        if not lus:
            return proto, []
        out_card = self._card(proto["out"])
        lv = torch.tensor(lus, device=dev)
        m = inc_done[..., None] & (lv > l[..., None]) & _flat_at(
            out_card == self.peers_ct, 2, pi[..., None] * nl + lv
        )
        # a second device read: does a level completion burst this tick?
        if not bool(m.any()):
            return proto, self._no_emissions(r, dev, len(lus))
        dests, oks, step = self._next_peer(proto, pi[..., None].expand(r, n, len(lus)), lv, lc)
        rows = m[..., None] & oks  # [R, N, X, lc]
        sl = slice(2, nl - 1)

        def add_at_proc(name, vals):  # x[r, n, pi, 2:nl-1] += vals
            x = proto[name]
            at = (torch.arange(P, device=dev) == pi[..., None])[..., None]
            x2 = x[..., sl] + torch.where(at, vals[:, :, None, :], 0)
            proto[name] = torch.cat([x[..., :2], x2, x[..., nl - 1:]], dim=-1)

        add_at_proc("pos", torch.where(m, step, 0))
        add_at_proc("contacted", rows.sum(-1).to(torch.int32))
        specs = [(rows[:, :, j], dests[:, :, j], pi, lu) for j, lu in enumerate(lus)]
        return proto, self._agg_emissions(proto, inc_cmp, out_card, specs)

    def all_done(self, state):
        return torch.zeros(state.down.shape[0], dtype=torch.bool, device=state.down.device)


def make_handeleth2(
    params: Optional[HandelEth2Parameters] = None,
    capacity: int = 1 << 14,
    seed: int = 0,
    device=None,  # None = CUDA; "cpu" runs the plain versions
):
    """Host-side construction from HandelEth2.init's replay
    (protocols/handeleth2.py: reception and emission ranks from the same
    JavaRandom stream), on the engine's default 512-row time wheel;
    returns (net, single-replica state)."""
    dev = resolve_device(device)
    params = params or HandelEth2Parameters()
    nodes, roles = handeleth2_roles(params)
    n = len(nodes)
    latency = registry_network_latencies.get_by_name(params.network_latency_name)
    cols = build_node_columns(nodes, getattr(latency, "city_index", None))
    proto = BatchedHandelEth2(params, roles, device=dev)
    # beat gating: node i's tick_beat fires at t = 1 + delta_i (mod
    # period_duration_ms); the PERIOD_TIME start/stop beat lands on the same
    # grid.  Where the residues cover the whole period, run_ms_batched
    # takes the ungated path on its own.
    if PERIOD_TIME % params.period_duration_ms == 0:
        pd = params.period_duration_ms
        proto.BEAT_PERIOD = pd
        proto.BEAT_RESIDUES = tuple(sorted({(1 + int(d)) % pd for d in roles["delta"]}))
        # _dissemination makes P * (nl - 1) emissions, one per (process, level)
        proto.BEAT_SEND_CALLS = P * (proto.nl - 1)
    net = BatchedNetwork(proto, latency, n, capacity=capacity, device=dev)
    state = net.init_state(cols, seed=seed, proto=proto.proto_init(n, device=dev),
                           down=roles["down"])
    return net, state
