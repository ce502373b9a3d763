"""Batched CasperIMD: beacon-chain stage-1 fork choice, ported to PyTorch.

A line-for-line port of the JAX package's protocols/casper_batched.py —
its module docstring gives the model: a block table indexed by height
(heights are unique per block by construction), ancestry as a dense
`anc[mH, mH]` bool matrix, countAttestations as one product of the
branch rows against the block-inclusion matrix, the slot schedule as
size-0 self-messages with explicit arrivals, one committee's attestation
broadcast as `[apr x N]` rows, and node 1 as one of four Byzantine
producer variants ("wf", "delay", "sf", "ns").  What changes here is
representation and what is computed, never the result:

  * every tensor carries the replica axis R in front ([R, N, ...]); the
    clock `t` is the engine's host int (the tie coin hashes it);
  * `deliver` compacts the delivered rows of the view first (one device
    read, `ops.indexing.live_rows`): the flat store's view is
    `[R, capacity]` (2^19 a replica at 1027 nodes), and every scatter
    takes only the delivered rows, as `True` into a trash column;
  * fork choice runs on the live (replica, node) rows only: `_best`
    leaves every row outside its mask at `o1` and the re-evaluation fold
    touches only acting rows, so both run over those rows, sized by a
    second device read that also says which block builds and which
    committee vote can fire.  A tick where no row acts skips the fold, a
    tick with no new block skips the arrival `_best`, and a build or
    vote no replica makes is not formed (its emission keeps its send
    counter with no rows, as one whose every row is masked does);
  * block builds run on the producer rows only: only producers build;
  * the three matrix products (`_count`, `_build`, and the attestation
    arrivals, which become a direct scatter of each delivered
    attestation's head) multiply 0/1 matrices.  PyTorch has no CUDA
    integer matmul, so they run in float32 on both devices: each sum is
    at most max_heights and is only tested > 0, exact far below 2^24
    (also under TF32, whose products of 0/1 are exact and whose sums
    accumulate in float32).

Casper runs on the flat store (`wheel_rows=0`): its self-messages land
whole 8-s slots ahead, far past any useful wheel horizon.  So its loop
reads no wheel occupancy and launches no hand-written kernel, as in the
JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.node import build_node_columns
from ..core.registries import registry_network_latencies
from ..engine.core import BatchedNetwork, Emission, resolve_device
from ..engine.protocol import BatchedProtocol
from ..engine.rng import hash32
from ..ops.indexing import live_rows, put_cells, take
from .casper import SLOT_DURATION, CasperParameters, casper_roles

VARIANTS = ("wf", "delay", "sf", "ns")


def _put(col: torch.Tensor, w: torch.Tensor, vals) -> torch.Tensor:
    """Functional `col.at[w].set(vals, mode="drop")` along dim 1 of col
    [R, H, ...]: w [R, P] with H = drop (a trash row); the kept rows'
    positions are distinct, as the JAX code relies on."""
    r, h = col.shape[:2]
    p = w.shape[1]
    rest = tuple(col.shape[2:])
    if not isinstance(vals, torch.Tensor) or vals.dim() == 0:
        vals = torch.as_tensor(vals, dtype=col.dtype, device=col.device)
    vals = vals.to(col.dtype).expand((r, p) + rest)
    idx = w.to(torch.int64).view((r, p) + (1,) * len(rest)).expand((r, p) + rest)
    ext = torch.cat([col, col[:, :1]], dim=1)
    return ext.scatter(1, idx, vals)[:, :h]


def _rows(col: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`col[r, idx[r, m]]` for col [R, N, ...] and idx [R, M] ->
    [R, M, ...]."""
    rest = tuple(col.shape[2:])
    r, m = idx.shape
    return torch.gather(col, 1, idx.view((r, m) + (1,) * len(rest)).expand((r, m) + rest))


class BatchedCasper(BatchedProtocol):
    MSG_TYPES = ["BLOCK", "ATT", "TBP", "TATT", "TWF", "TWFB", "TBYZ"]
    PAYLOAD_WIDTH = 2
    TICK_INTERVAL = None  # all timing is explicit-arrival self-messages

    def __init__(
        self,
        params: CasperParameters,
        roles: dict,
        max_heights: int,
        byz_variant: str = "wf",
        byz_delay: int = 0,
        device=None,
    ):
        if byz_variant not in VARIANTS:
            raise ValueError(f"unknown byz_variant {byz_variant!r}")
        self.byz_variant = byz_variant
        self.byz_delay = byz_delay
        self.params = params
        self.mh = max_heights
        self.apr = params.attesters_per_round
        self.cl = params.cycle_length
        self.bpc = params.block_producers_count
        self.ma = max_heights * self.apr  # attestation slots: (h-1)*apr + j
        self.n_nodes = int(roles["n_nodes"])
        dev = resolve_device(device)

        def i32(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.int32, device=dev)

        self.is_att = torch.as_tensor(roles["is_att"], device=dev)
        self.is_bp = torch.as_tensor(roles["is_bp"], device=dev)  # honest producers (not bp0)
        self.bp0 = int(roles["bp0"])  # the Byzantine producer's node id
        self.att_ids = i32(roles["att_ids"])
        self.committee = np.asarray(roles["committee"], np.int32)  # [cl, apr], host
        self.prod_ids = i32(roles["prod_ids"])  # bp0 + honest
        self.all_ids = torch.arange(self.n_nodes, dtype=torch.int32, device=dev)
        self.hr = torch.arange(max_heights, dtype=torch.int32, device=dev)
        # static window matrix: attestation a may sit in block cur's count
        # window only when att_h(a) < cur (heights [H+1, cur-1], :271-276)
        att_h = np.arange(self.ma) // self.apr + 1
        self.att_h = i32(att_h)
        self.win = torch.as_tensor(att_h[None, :] < np.arange(max_heights)[:, None], device=dev)
        # attester committee-member index (i // cycle_length), 0 elsewhere
        att_j = np.zeros(self.n_nodes, np.int32)
        att_j[np.asarray(roles["att_ids"])] = np.asarray(roles["att_cidx"])
        self.att_j = att_j

    def msg_size(self, mtype: int) -> int:
        return 1 if self.MSG_TYPES[mtype] in ("BLOCK", "ATT") else 0

    def proto_init(self, n_nodes: int):
        mh, ma, n = self.mh, self.ma, n_nodes
        dev = self.hr.device

        def zi(*s):
            return torch.zeros(s, dtype=torch.int32, device=dev)

        def zb(*s):
            return torch.zeros(s, dtype=torch.bool, device=dev)

        seen = zb(n, mh)
        seen[:, 0] = True  # genesis known
        blk_exists = zb(mh)
        blk_exists[0] = True
        return {
            # global block table (one block per height; 0 = genesis)
            "blk_exists": blk_exists,
            "blk_parent": torch.full((mh,), -1, dtype=torch.int32, device=dev),
            "blk_time": zi(mh),
            "anc": zb(mh, mh),
            "blk_att": zb(mh, ma),
            # global attestation table
            "att_exists": zb(ma),
            "att_head": zi(ma),
            # per-node state
            "head": zi(n),
            "seen": seen,
            "rec_att": zb(n, ma),
            "reeval": zb(n, mh),
            # ByzBlockProducer* bookkeeping (row bp0 only; :511-707):
            # wf_to_send doubles as every variant's toSend cursor
            "wf_to_send": torch.ones(n, dtype=torch.int32, device=dev),
            "wf_late": zi(n),
            "wf_on_time": zi(n),
            "byz_direct": zi(n),  # onDirectFather
            "byz_older": zi(n),  # onOlderAncestor
            "byz_skipped": zi(n),  # NS skipped
        }

    # -- fork choice ---------------------------------------------------------
    def fork_context(self, proto) -> tuple:
        """What every `_count` of one deliver reads and nothing before the
        builds changes: the windowed inclusion matrix as float32 [R, mH,
        mA], and anc[att_head[a], h] as [R, mH, mA]."""
        inc = (proto["blk_att"] & self.win).to(torch.float32)
        head = proto["att_head"].to(torch.int64)
        anc_att = torch.gather(proto["anc"], 1, head[..., None].expand(-1, -1, self.mh))
        return inc, anc_att.transpose(1, 2)

    def _count(self, proto, ctx, rec_r, start, a_start, hcn):
        """countAttestations(start, H) over [R, M] rows (CasperIMD.java:262-288):
        rec_r [R, M, mA] the rows' received attestations, a_start [R, M, mH]
        anc[start], hcn [R, M] the heights of H."""
        inc, anc_att_t = ctx
        r, m = start.shape
        ma = self.ma
        branch = (a_start | (self.hr == start[..., None])) & (self.hr > hcn[..., None])
        # from blocks: exists cur on the branch including a within window
        from_blocks = torch.bmm(branch.to(torch.float32), inc) > 0  # [R, M, mA]
        from_blocks = from_blocks & (self.att_h > hcn[..., None])
        # from direct reception: attestation's head lies on the branch
        head = proto["att_head"]
        from_recv = rec_r & torch.gather(branch, 2, head.long()[:, None, :].expand(r, m, ma))
        # attests(H): H strict ancestor of the head, within cycleLength
        att_ok = (
            proto["att_exists"][:, None, :]
            & torch.gather(anc_att_t, 1, hcn.long()[..., None].expand(r, m, ma))
            & (hcn[..., None] >= head[:, None, :] - self.cl)
        )
        return (att_ok & (from_blocks | from_recv)).sum(-1).to(torch.int32)

    def _best_rows(self, proto, ctx, rec_r, node, o1, o2, mask, seed, t: int):
        """Pairwise best(o1, o2) (CasperIMD.java:204-257) over [R, M] rows;
        node [R, M] the rows' node ids, seed [R] the replicas' seeds."""
        anc = proto["anc"]
        a1, a2 = _rows(anc, o1.long()), _rows(anc, o2.long())
        same = o1 == o2
        direct = (torch.gather(a1, 2, o2.long()[..., None])[..., 0]
                  | torch.gather(a2, 2, o1.long()[..., None])[..., 0])
        hi = torch.maximum(o1, o2)
        # first common (strict) ancestor
        hcn = torch.where(a1 & a2, self.hr, 0).amax(-1).to(torch.int32)
        v1 = self._count(proto, ctx, rec_r, o1, a1, hcn)
        v2 = self._count(proto, ctx, rec_r, o2, a2, hcn)
        if self.params.random_on_ties:
            coin = (hash32(seed[:, None], t, node, o1, o2) & 1) == 0
            tie = torch.where(coin, o1, o2)
        else:
            # (blk_time, height) keys compare in int32
            k1 = take(proto["blk_time"], o1) * self.mh + o1
            k2 = take(proto["blk_time"], o2) * self.mh + o2
            tie = torch.where(k1 >= k2, o1, o2)
        by_votes = torch.where(v1 > v2, o1, torch.where(v2 > v1, o2, tie))
        win = torch.where(same, o1, torch.where(direct, hi, by_votes))
        return torch.where(mask, win, o1)

    def _best(self, proto, ctx, o1, o2, rows, seed, t: int):
        """The JAX package's `_best(o1, o2, mask)` for [R, N] heights, with
        `rows` = live_rows([mask]) (None: no row in the mask, o1 stays)."""
        if rows is None:
            return o1
        idx, live = rows
        win = self._best_rows(proto, ctx, _rows(proto["rec_att"], idx), idx,
                              _rows(o1, idx), _rows(o2, idx), live, seed, t)
        return _put(o1, torch.where(live, idx, self.n_nodes), win)

    def _reevaluate(self, proto, ctx, acting, rows, seed, t: int):
        """Lazy head re-election: fold best over the pending candidates in
        height order (reevaluateHead, CasperIMD.java:348-353), over the
        acting rows `rows` = live_rows([acting])."""
        if rows is None:
            return proto
        idx, live = rows
        head = _rows(proto["head"], idx)
        reeval = _rows(proto["reeval"], idx)
        rec_r = _rows(proto["rec_att"], idx)
        for i in range(1, self.mh):
            head = self._best_rows(proto, ctx, rec_r, idx, head, torch.full_like(head, i),
                                   reeval[..., i] & live, seed, t)
        return dict(
            proto,
            head=_put(proto["head"], torch.where(live, idx, self.n_nodes), head),
            reeval=proto["reeval"] & ~acting[..., None],
        )

    # -- block building (buildBlock, :383-428) -------------------------------
    def _build_blocks(self, proto, mask, base, height, t: int):
        """Producers in `mask` create block `height` on parent `base` ([R, N]
        columns; only producers ever build, so the work runs on their rows):
        include every received attestation on the parent chain (within the
        cycle window) not already included in it."""
        mh, n = self.mh, self.n_nodes
        pid = self.prod_ids.long()
        m, b, h = mask[:, pid], base[:, pid].long(), height[:, pid]
        r, p = m.shape
        a_b = _rows(proto["anc"], b) | (self.hr == b[..., None])  # anc[base] | onehot(base)
        # parent-chain blocks within the window [height - cl, ...]
        chain = a_b & (self.hr >= (h - self.cl)[..., None]) & (self.hr > 0)
        included = torch.bmm(chain.to(torch.float32),
                             proto["blk_att"].to(torch.float32)) > 0  # [R, P, mA]
        head = proto["att_head"]
        head_on_chain = torch.gather(chain, 2, head.long()[:, None, :].expand(r, p, self.ma))
        rec_p = proto["rec_att"][:, pid]
        before = (self.att_h < h[..., None]) & ~included
        mine = rec_p & head_on_chain & before
        # genesis-headed attestations: head 0 is never on `chain` (height>0
        # filter) but the oracle's walk does visit down to the window edge
        mine0 = rec_p & (head == 0)[:, None, :] & (0 >= h - self.cl)[..., None] & before
        mine = mine | mine0

        # the new blocks into the global tables (heights unique)
        w_h = torch.where(m, h, mh)
        proto = dict(proto)
        proto["blk_exists"] = _put(proto["blk_exists"], w_h, True)
        proto["blk_parent"] = _put(proto["blk_parent"], w_h, b)
        proto["blk_time"] = _put(proto["blk_time"], w_h, t)
        proto["anc"] = _put(proto["anc"], w_h, a_b)
        proto["blk_att"] = _put(proto["blk_att"], w_h, mine)
        # the producer's head becomes its new block immediately (:425-427)
        proto["head"] = torch.where(mask, height, proto["head"])
        proto["seen"] = put_cells(proto["seen"], pid * mh + h.long(), True, m)

        # broadcast rows restricted to the (few, static) producer ids
        hs = h.repeat_interleave(n, dim=1)
        em = Emission(
            mask=m.repeat_interleave(n, dim=1),
            from_idx=self.prod_ids.repeat_interleave(n),
            to_idx=self.all_ids.repeat(p),
            mtype=self.mtype("BLOCK"),
            payload=torch.stack([hs, torch.zeros_like(hs)], dim=-1),
            send_time=t + self.params.block_construction_time,
        )
        return proto, em

    def _timer(self, mask, mtype: str, arrival, payload=None) -> Emission:
        """A per-node self-message with an explicit arrival."""
        return Emission(mask=mask, from_idx=self.all_ids, to_idx=self.all_ids,
                        mtype=self.mtype(mtype), payload=payload,
                        arrival=torch.as_tensor(arrival, dtype=torch.int32,
                                                device=mask.device).expand(mask.shape))

    def _no_rows(self, r: int, mtype: str) -> Emission:
        return Emission.no_rows(r, self.mtype(mtype), self.PAYLOAD_WIDTH, self.hr.device)

    def initial_emissions(self, net, state):
        """The init task schedule (CasperIMD.java:472-508) as explicit
        arrivals: bp0 (WF) at SLOT, honest producer i at SLOT*(i+1),
        attester committee c at SLOT*(1+c)+4000."""
        r = state.proto["head"].shape[0]
        ids = self.all_ids
        is_bp0 = (ids == self.bp0).expand(r, -1)
        if self.byz_variant == "wf":
            em0 = self._timer(is_bp0, "TWF", SLOT_DURATION)  # WF kick-off tick
        else:
            # delay/sf/ns: periodic at SLOT + delay (CasperIMD.java:486-492)
            em0 = self._timer(is_bp0, "TBYZ", SLOT_DURATION + self.byz_delay)
        arr_bp = torch.where(self.is_bp, SLOT_DURATION * (ids - self.bp0 + 1), 1)
        cidx = np.zeros(self.n_nodes, np.int64)
        cidx[self.att_ids.cpu().numpy()] = np.arange(self.att_ids.numel()) % self.cl
        arr_att = torch.as_tensor(SLOT_DURATION * (1 + cidx) + 4000, device=ids.device)
        return [
            em0,
            self._timer(self.is_bp.expand(r, -1), "TBP", arr_bp),
            self._timer(self.is_att.expand(r, -1), "TATT", arr_att),
        ]

    # -- per-event processing ------------------------------------------------
    def deliver(self, net, state, deliver_mask, t: int):
        p = self.params
        proto = dict(state.proto)
        r = deliver_mask.shape[0]
        n, mh, ma = self.n_nodes, self.mh, self.ma
        dev = deliver_mask.device
        slot_now = t // SLOT_DURATION
        seed = state.seed

        # the delivered rows of the view, compacted (one device read)
        (rows,) = live_rows([deliver_mask])
        if rows is None:
            idx = torch.zeros((r, 0), dtype=torch.int64, device=dev)
            live = torch.zeros((r, 0), dtype=torch.bool, device=dev)
        else:
            idx, live = rows
        to = torch.gather(state.msg_to, 1, idx).long()
        mt = torch.gather(state.msg_type, 1, idx)
        pay = _rows(state.msg_payload, idx)
        pay0, pay1 = pay[..., 0], pay[..., 1]

        def m_(name):
            return live & (mt == self.mtype(name))

        def flag(name):  # zeros(n, bool).at[to].max(is_x)
            return put_cells(torch.zeros((r, n), dtype=torch.bool, device=dev), to, True,
                             m_(name))

        is_blk, is_att, is_twfb = m_("BLOCK"), m_("ATT"), m_("TWFB")
        tbp, tatt = flag("TBP"), flag("TATT")
        if self.byz_variant == "wf":
            twf, tbyz = flag("TWF"), torch.zeros_like(tbp)
        else:
            twf, tbyz = torch.zeros_like(tbp), flag("TBYZ")
        emissions = []

        # ---- 1. attestation arrivals (onAttestation, :316-337) ------------
        h0 = torch.clamp(pay0, 0, ma - 1).long()
        ok_att = is_att & torch.gather(proto["att_exists"], 1, h0)
        proto["rec_att"] = put_cells(proto["rec_att"], to * ma + h0, True, ok_att)
        # reevaluate the attested head when the block is known: the JAX
        # package's new_att @ one_hot(att_head) product, as a scatter of
        # each delivered attestation's head
        att_cell = to * mh + torch.gather(proto["att_head"], 1, h0).long()
        known = torch.gather(proto["seen"].reshape(r, n * mh), 1, att_cell)
        proto["reeval"] = put_cells(proto["reeval"], att_cell, True, ok_att & known)

        # ---- 2. block arrivals (onBlock, :298-314; slot gate is dead
        # code in the reference — delta sign bug kept verbatim) -------------
        bh = torch.clamp(pay0, 0, mh - 1).long()
        new_blk = put_cells(torch.zeros((r, n, mh), dtype=torch.bool, device=dev),
                            to * mh + bh, True, is_blk)
        new_blk = new_blk & ~proto["seen"] & proto["blk_exists"][:, None, :]
        got_blk = new_blk.any(-1)

        # which rows choose, and which builds and votes fire (a superset
        # for the WF kick-off, which also reads the head): one device read
        wf_th = torch.zeros((r, n), dtype=torch.int32, device=dev).scatter_reduce(
            1, to, torch.where(is_twfb, pay1, 0), reduce="amax", include_self=True)
        twfb = put_cells(torch.zeros((r, n), dtype=torch.bool, device=dev), to, True, is_twfb)
        acting = tbp | tatt | twf | tbyz
        can_vote = tatt & (1 <= slot_now < mh)
        rows_blk, rows_act, fire_bp, fire_kick, fire_wf, fire_byz, fire_vote = live_rows([
            got_blk, acting, tbp & (slot_now < mh), twf, twfb & (wf_th < mh),
            tbyz & (proto["wf_to_send"] < mh), can_vote,
        ])
        ctx = None if rows_blk is None and rows_act is None else self.fork_context(proto)

        proto["seen"] = proto["seen"] | new_blk
        # reevaluate old head later; immediate pairwise best against the
        # highest new block (BlockChainNode.onBlock head update)
        best_new = torch.where(new_blk, self.hr, 0).amax(-1).to(torch.int32)
        old_head = (self.hr == proto["head"][..., None]) & got_blk[..., None]
        proto["reeval"] = proto["reeval"] | old_head | new_blk
        proto["head"] = self._best(proto, ctx, proto["head"], best_new, rows_blk, seed, t)

        ids = self.all_ids
        if self.byz_variant == "wf":
            # WF producer response (:660-676): fires when the awaited parent
            # (toSend-1) is among THIS tick's new blocks
            want = torch.clamp(proto["wf_to_send"] - 1, 0, mh - 1)
            wf_hit = (ids == self.bp0) & torch.gather(new_blk, 2, want.long()[..., None])[..., 0]
            th = proto["wf_to_send"]
            perfect = SLOT_DURATION * th + self.byz_delay
            fire_now = wf_hit & (t >= perfect)
            fire_later = wf_hit & ~fire_now
            proto["wf_late"] = proto["wf_late"] + fire_now.to(torch.int32)
            proto["wf_on_time"] = proto["wf_on_time"] + fire_later.to(torch.int32)
            proto["wf_to_send"] = torch.where(wf_hit, th + self.bpc, th)
            # the scheduled build (registerTask(r, perfectDate))
            emissions.append(self._timer(wf_hit, "TWFB", torch.clamp(perfect, min=t + 1),
                                         torch.stack([want, th], dim=-1)))

            # ---- 3. WF kick-off (periodic while nothing produced, :692-698)
            wf_kick = twf & (proto["head"] == 0) & (proto["wf_to_send"] == 1)
            proto["wf_to_send"] = torch.where(wf_kick, 1 + self.bpc, proto["wf_to_send"])
            # re-arm the kick-off watchdog
            emissions.append(self._timer(twf, "TWF", t + SLOT_DURATION * self.bpc))

        # ---- 4. honest producers fire (reevaluate + build, :365-381) ------
        emissions.append(self._timer(tbp, "TBP", t + SLOT_DURATION * self.bpc))
        # ---- 5. attesters fire (vote at 4 s, :444-464) --------------------
        emissions.append(self._timer(tatt, "TATT", t + SLOT_DURATION * self.cl))

        # one reevaluation pass for every node acting this tick
        proto = self._reevaluate(proto, ctx, acting, rows_act, seed, t)

        # honest production: height = slot index (:370-377)
        if fire_bp is None:
            emissions.append(self._no_rows(r, "BLOCK"))
        else:
            proto, em = self._build_blocks(proto, tbp & (slot_now < mh), proto["head"],
                                           torch.full_like(proto["head"], slot_now), t)
            emissions.append(em)

        if self.byz_variant == "wf":
            # WF kick-off build: block 1 on genesis (reevaluateH at genesis)
            if fire_kick is None:
                emissions.append(self._no_rows(r, "BLOCK"))
            else:
                zero = torch.zeros_like(proto["head"])
                proto, em = self._build_blocks(proto, wf_kick, zero, zero + 1, t)
                emissions.append(em)
            # ---- 6. WF scheduled build lands (r(), :663-668) --------------
            if fire_wf is None:
                emissions.append(self._no_rows(r, "BLOCK"))
            else:
                wf_base = torch.zeros_like(wf_th).scatter_reduce(
                    1, to, torch.where(is_twfb, pay0, 0), reduce="amax", include_self=True)
                proto, em = self._build_blocks(proto, twfb & (wf_th < mh), wf_base, wf_th, t)
                emissions.append(em)
        else:
            proto, ems = self._byz_fire(proto, tbyz, fire_byz is not None, t)
            emissions += ems

        # attester votes: create the attestation and broadcast it ------------
        if fire_vote is None:
            emissions.append(self._no_rows(r, "ATT"))
        else:
            vote_h = slot_now
            att_slot = np.clip((vote_h - 1) * self.apr + self.att_j, 0, ma - 1)
            att_slot_t = torch.as_tensor(att_slot, dtype=torch.int64, device=dev)
            w_a = torch.where(can_vote, att_slot_t, ma)
            proto["att_exists"] = _put(proto["att_exists"], w_a, True)
            proto["att_head"] = _put(proto["att_head"], w_a, proto["head"])
            # the attester holds its own attestation from the start
            proto["rec_att"] = put_cells(proto["rec_att"], ids.long() * ma + att_slot_t, True,
                                         can_vote)
            # committee of this slot shares the tick: [apr x N] rows
            cm = self.committee[(vote_h - 1) % self.cl]
            cm_t = torch.as_tensor(cm, dtype=torch.int32, device=dev)
            slots = torch.as_tensor(np.repeat(att_slot[cm], n), dtype=torch.int32, device=dev)
            emissions.append(Emission(
                mask=can_vote[:, cm_t.long()].repeat_interleave(n, dim=1),
                from_idx=cm_t.repeat_interleave(n),
                to_idx=ids.repeat(self.apr),
                mtype=self.mtype("ATT"),
                payload=torch.stack([slots, torch.zeros_like(slots)], dim=-1).expand(r, -1, -1),
                send_time=t + p.attestation_construction_time,
            ))

        return state._replace(proto=proto), emissions

    def _byz_fire(self, proto, tbyz, fires: bool, t: int):
        """The head-start producers (delay/sf/ns) fire on their own beat:
        reevaluateH + the variant's head tweak + build
        (CasperIMD.java:529-542 + :285-300/:318-327/:342-356), then re-arm.
        `fires`: whether any replica's producer builds this tick."""
        mh, r = self.mh, tbyz.shape[0]
        th = proto["wf_to_send"]
        # deepest ancestor of head strictly below toSend (the
        # while-head.height>=toSend parent walk)
        head = proto["head"].long()
        cand = (_rows(proto["anc"], head) | (self.hr == head[..., None])) & (
            self.hr < th[..., None])
        base = torch.where(cand, self.hr, 0).amax(-1).to(torch.int32)
        direct = base == th - 1
        parent = proto["blk_parent"]
        if self.byz_variant == "sf":
            # skip the direct father to steal its transactions
            skip = tbyz & (base != 0) & direct
            base = torch.where(skip, torch.clamp(take(parent, base), 0, mh - 1), base)
            proto["byz_direct"] = proto["byz_direct"] + skip.to(torch.int32)
            proto["byz_older"] = proto["byz_older"] + (tbyz & ~skip).to(torch.int32)
        elif self.byz_variant == "ns":
            # skip the father when the father skipped the grandfather
            gp = torch.clamp(take(parent, base), 0, mh - 1)
            h2 = torch.clamp(th - 2, 0, mh - 1)
            cond = (
                tbyz
                & (base != 0)
                & direct
                & (gp == th - 3)
                & torch.gather(proto["seen"], 2, h2.long()[..., None])[..., 0]
                & take(proto["blk_exists"], h2)
            )
            base = torch.where(cond, h2, base)
            proto["byz_skipped"] = proto["byz_skipped"] + cond.to(torch.int32)
        else:  # plain delay: counters only
            proto["byz_direct"] = proto["byz_direct"] + (tbyz & direct).to(torch.int32)
            proto["byz_older"] = proto["byz_older"] + (tbyz & ~direct).to(torch.int32)
        if fires:
            proto, em = self._build_blocks(proto, tbyz & (th < mh), base, th, t)
        else:
            em = self._no_rows(r, "BLOCK")
        proto["wf_to_send"] = torch.where(tbyz, th + self.bpc, th)
        # re-arm the byz beat
        return proto, [em, self._timer(tbyz, "TBYZ", t + SLOT_DURATION * self.bpc)]

    def all_done(self, state):
        # open-ended, like the oracle
        return torch.zeros(state.down.shape[0], dtype=torch.bool, device=state.down.device)

    def head_height(self, state):
        return state.proto["head"]


def make_casper(
    params: Optional[CasperParameters] = None,
    max_heights: int = 24,
    capacity: Optional[int] = None,
    seed: int = 0,
    byz_variant: str = "wf",
    byz_delay: int = 0,
    device=None,  # None = CUDA; "cpu" runs the plain versions
):
    """Host-side construction from the oracle's init (observer + the chosen
    Byzantine producer variant + honest producers + attesters, same RNG)
    on the flat store; returns (net, single-replica state).  byz_variant
    selects node 1's producer: "wf" (default, ByzBlockProducerWF),
    "delay", "sf", "ns" (CasperIMD.java:511-707)."""
    dev = resolve_device(device)
    params = params or CasperParameters()
    nodes, roles = casper_roles(params)
    n = len(nodes)
    latency = registry_network_latencies.get_by_name(params.network_latency_name)
    cols = build_node_columns(nodes, getattr(latency, "city_index", None))
    proto = BatchedCasper(params, roles, max_heights, byz_variant, byz_delay, device=dev)
    if capacity is None:
        # the peak in-flight load is one committee's attestation broadcast
        # plus scheduled self-messages; a full store DROPS new sends, so
        # auto-size to 1.5 waves (the JAX package's formula)
        wave = params.attesters_per_round * n + 4 * n
        capacity = max(1 << 14, 1 << int(np.ceil(np.log2(1.5 * wave))))
    net = BatchedNetwork(proto, latency, n, capacity=capacity, wheel_rows=0, device=dev)
    state = net.init_state(cols, seed=seed, proto=proto.proto_init(n))
    return net, state
