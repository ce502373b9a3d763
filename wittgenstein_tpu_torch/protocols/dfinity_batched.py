"""Batched Dfinity: the three-role random-beacon consensus, ported to PyTorch.

A line-for-line port of the JAX package's protocols/dfinity_batched.py —
its module docstring gives the model in full: the preallocated block
table (slot = (height-1) * n_bp + producer), fork choice as a max over
(height, -slot) keys, vote and beacon-exchange sets as counters, and the
far-future beacon re-exchange as an emission with an explicit send time.
What changes here is representation only:

  * every tensor carries the replica axis R in front ([R, N, ...]);
  * the clock `t` is the engine's host int;
  * `.at[i, j].max(bool)` scatters become int32 scatter-adds tested > 0
    (an OR), and two-index scatters become one linear index per row.

Dfinity is event-driven (TICK_INTERVAL None): its re-exchange lands past
the 512-ms wheel horizon, so it keeps long-lived entries in the overflow
lane while the engine jumps over the dead time between rounds.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.node import build_node_columns
from ..core.registries import registry_network_latencies
from ..engine.core import BatchedNetwork, Emission, resolve_device
from ..engine.protocol import BatchedProtocol
from ..ops.indexing import take
from .dfinity import DfinityParameters, dfinity_population


def _or_at(r: int, size: int, idx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """bool[R, size]: `zeros.at[idx].max(mask)` per replica, as a count > 0."""
    out = torch.zeros((r, size), dtype=torch.int32, device=mask.device)
    return out.scatter_add(1, idx.reshape(r, -1), mask.reshape(r, -1).to(torch.int32)) > 0


def _set_one(col: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Functional `col[r, n, idx[r, n]] = vals[r, n]` for col [R, N, M]."""
    return col.scatter(2, idx[..., None], vals[..., None].to(col.dtype))


def _get_one(col: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`col[r, n, idx[r, n]]` for col [R, N, M] -> [R, N]."""
    return torch.gather(col, 2, idx[..., None])[..., 0]


class BatchedDfinity(BatchedProtocol):
    MSG_TYPES = ["PROPOSAL", "VOTE", "RBE", "RBR", "SEND_BLOCK"]
    PAYLOAD_WIDTH = 2  # (block slot | height, rd)
    TICK_INTERVAL = None  # pure message protocol

    def __init__(self, params: DfinityParameters, roles: dict, max_heights: int, device=None):
        self.params = params
        self.max_heights = max_heights
        self.n_att = params.attesters_count
        self.n_bp = params.block_producers_count
        self.n_bcn = params.random_beacon_count
        self.n_nodes = 1 + self.n_att + self.n_bp + self.n_bcn  # + observer
        self.max_b = max_heights * self.n_bp
        dev = resolve_device(device)

        def i32(a):
            return torch.as_tensor(a, dtype=torch.int32, device=dev)

        # static role columns
        self.is_att = torch.as_tensor(roles["is_att"], device=dev)
        self.is_bp = torch.as_tensor(roles["is_bp"], device=dev)
        self.is_bcn = torch.as_tensor(roles["is_bcn"], device=dev)
        self.my_round = i32(roles["my_round"])
        self.bp_local = i32(roles["bp_local"])  # -1 if not a producer
        self.att_ids = i32(roles["att_ids"])
        self.bp_ids = i32(roles["bp_ids"])
        self.bcn_ids = i32(roles["bcn_ids"])
        self.all_ids = torch.arange(self.n_nodes, dtype=torch.int32, device=dev)
        self.slots = torch.arange(self.max_b, dtype=torch.int32, device=dev)
        self.h_of = self._slot_h(self.slots)  # [mb]

    def proto_init(self, n_nodes: int):
        n, mb, mh = self.n_nodes, self.max_b, self.max_heights
        dev = self.all_ids.device

        def zi(*s):
            return torch.zeros(s, dtype=torch.int32, device=dev)

        def zb(*s):
            return torch.zeros(s, dtype=torch.bool, device=dev)

        def full(v, *s):
            return torch.full(s, v, dtype=torch.int32, device=dev)

        return {
            "blk_exists": zb(mb),
            "blk_time": zi(mb),
            "blk_parent": full(-1, mb),
            "seen": zb(n, mb),
            "head_slot": full(-1, n),  # -1 = genesis
            "cm_blk": zb(n, mb),
            "cm_h": zb(n, mh + 2),
            "last_beacon": zi(n),
            "vote_for_h": full(-1, n),
            "self_voted": zb(n, mb),
            "vote_cnt": zi(n, mb),
            "prop_buf": zb(n, mb),
            # beacon state (send_rb already pre-applied for t=0 init)
            "bcn_height": full(1, n),
            "bcn_last_sent": full(1, n),
            "exch_cnt": zi(n, mh + 2),
            "exch_self": zb(n, mh + 2),
        }

    # -- helpers -------------------------------------------------------------
    def _slot_h(self, slot):
        return torch.div(slot, self.n_bp, rounding_mode="floor") + 1

    def _head_h(self, head_slot):
        return torch.where(head_slot < 0, 0, self._slot_h(head_slot))

    def _emission(self, mask_col, senders, receivers, mtype, pay0, pay1=None,
                  send_time=None):
        """An all-pairs emission from `senders` to `receivers` (sender-major,
        jnp.repeat / jnp.tile order): per-sender [R, N] columns pick each
        sender's mask, payload and send time."""
        k_to = receivers.numel()

        def rep(col):
            return col[:, senders.long()].repeat_interleave(k_to, dim=1)

        p0 = rep(pay0)
        p1 = rep(pay1) if pay1 is not None else torch.zeros_like(p0)
        if isinstance(send_time, torch.Tensor):
            send_time = rep(send_time)
        return Emission(
            mask=rep(mask_col),
            from_idx=senders.repeat_interleave(k_to),
            to_idx=receivers.repeat(senders.numel()),
            mtype=self.mtype(mtype),
            payload=torch.stack([p0, p1], dim=-1),
            send_time=send_time,
        )

    def initial_emissions(self, net, state):
        """init (Dfinity.java:426-450): every beacon node send_rb()s the
        height-1 beacon to all nodes at t + attestation_construction_time."""
        p = self.params
        k = self.n_bcn * self.n_nodes
        dev = self.all_ids.device
        ones = torch.ones((1, k), dtype=torch.int32, device=dev)
        return [
            Emission(
                mask=torch.ones((1, k), dtype=torch.bool, device=dev),
                from_idx=self.bcn_ids.repeat_interleave(self.n_nodes),
                to_idx=self.all_ids.repeat(self.n_bcn),
                mtype=self.mtype("RBR"),
                payload=torch.stack([ones, ones], dim=-1),
                send_time=torch.full((k,), p.attestation_construction_time,
                                     dtype=torch.int32, device=dev),
            )
        ]

    # -- the whole protocol runs in deliver ----------------------------------
    def deliver(self, net, state, deliver_mask, t: int):
        p = self.params
        proto = dict(state.proto)
        n, mb, mh = self.n_nodes, self.max_b, self.max_heights
        r = deliver_mask.shape[0]
        to, frm = state.msg_to, state.msg_from
        pay0 = state.msg_payload[..., 0].clamp(0, mb - 1)
        payh = state.msg_payload[..., 0].clamp(0, mh + 1)
        h_of, slots = self.h_of, self.slots
        is_att_c = self.is_att[:, None]
        emissions = []

        mt = state.msg_type
        is_prop = deliver_mask & (mt == self.mtype("PROPOSAL"))
        is_vote = deliver_mask & (mt == self.mtype("VOTE"))
        is_rbe = deliver_mask & (mt == self.mtype("RBE"))
        is_rbr = deliver_mask & (mt == self.mtype("RBR"))
        is_sblk = deliver_mask & (mt == self.mtype("SEND_BLOCK"))
        cell = to.long() * mb + pay0.long()  # (receiver, block slot)

        # ---- A. block arrivals (on_block, BlockChainNode + roles) ---------
        new_blk = _or_at(r, n * mb, cell, is_sblk).view(r, n, mb)
        new_blk = new_blk & ~proto["seen"] & proto["blk_exists"][:, None, :]
        proto["seen"] = proto["seen"] | new_blk

        # fork choice: height-with-incumbent-ties (comparator :107-130)
        key = torch.where(new_blk, h_of * (mb + 1) + (mb - slots), -1)
        best_key = key.amax(-1)
        best_slot = torch.where(best_key >= 0, mb - best_key % (mb + 1), -1)
        best_h = torch.where(best_key >= 0, torch.div(best_key, mb + 1, rounding_mode="floor"), 0)
        cur_h = self._head_h(proto["head_slot"])
        adopt = best_h > cur_h
        proto["head_slot"] = torch.where(adopt, best_slot, proto["head_slot"]).to(torch.int32)
        head_h = self._head_h(proto["head_slot"])

        # attester on_block (:229-236): committee sets + vote reset
        att_new = new_blk & is_att_c
        proto["cm_blk"] = proto["cm_blk"] | att_new
        got_h = torch.zeros((r, n, mh + 2), dtype=torch.int32, device=to.device).scatter_add(
            2, h_of.long().expand(r, n, mb), att_new.to(torch.int32)
        ) > 0
        proto["cm_h"] = proto["cm_h"] | got_h
        vreset = torch.any(att_new & (h_of == proto["vote_for_h"][..., None]), dim=-1)
        proto["vote_for_h"] = torch.where(vreset, -1, proto["vote_for_h"])

        # beacon on_block (:387-410): height advance + exchange/send_rb
        bcn_adv = self.is_bcn & new_blk.any(-1) & (head_h == proto["bcn_height"])
        nh = (proto["bcn_height"] + 1).clamp(0, mh + 1)
        proto["bcn_height"] = torch.where(bcn_adv, nh, proto["bcn_height"])
        h_idx = torch.where(bcn_adv, nh, 0).long()
        had_self = _get_one(proto["exch_self"], h_idx)
        add_self = bcn_adv & ~had_self
        proto["exch_self"] = _set_one(proto["exch_self"], h_idx, had_self | add_self)
        proto["exch_cnt"] = proto["exch_cnt"].scatter_add(
            2, h_idx[..., None], add_self[..., None].to(torch.int32)
        )
        rb_now_a = add_self & (_get_one(proto["exch_cnt"], h_idx) >= p.majority)
        # not enough exchanges yet: schedule RandomBeaconExchange(newH) to
        # the beacon committee at wt = head.parent.proposalTime + 2*roundTime
        need_exch = bcn_adv & ~rb_now_a
        head_c = proto["head_slot"].clamp(0, mb - 1).long()
        par = torch.gather(proto["blk_parent"], 1, head_c)
        par_time = torch.where(
            proto["head_slot"] < 0,
            0,
            torch.where(par < 0, 0, torch.gather(proto["blk_time"], 1, par.clamp(0, mb - 1).long())),
        )
        wt = par_time + 2 * p.round_time
        wt = torch.where(wt <= t, t + p.attestation_construction_time, wt).to(torch.int32)
        emissions.append(
            self._emission(need_exch, self.bcn_ids, self.bcn_ids, "RBE", nh, send_time=wt)
        )

        # ---- B. beacon results (on_random_beacon, :133-140) ---------------
        rbr_h = torch.zeros((r, n), dtype=torch.int32, device=to.device).scatter_reduce(
            1, to.long(), torch.where(is_rbr, payh, 0), reduce="amax"
        )
        trig = rbr_h > proto["last_beacon"]
        # rd == height for every beacon (send_rb :274-279), so rd = rbr_h
        rd = rbr_h
        proto["last_beacon"] = torch.where(trig, rbr_h, proto["last_beacon"])

        # BP: propose when selected and the parent is in hand (:177-181)
        bp_sel = (
            trig
            & self.is_bp
            & (rd % p.block_producers_round == self.my_round)
            & (head_h == rbr_h - 1)
            & (rbr_h <= mh)
        )
        new_slot = ((rbr_h - 1) * self.n_bp + self.bp_local).clamp(0, mb - 1)
        # one writer per slot: a selected producer writes (h-1)*n_bp + its
        # own index with 1 <= h <= mh, distinct across producers, so the
        # set is exact; unselected rows go to a trash column
        w_slot = torch.where(bp_sel, new_slot, mb).long()

        def put_blk(col, vals):
            ext = torch.cat([col, col[:, :1]], dim=1)
            return ext.scatter(1, w_slot, vals.to(col.dtype).expand(r, n))[:, :mb]

        proto["blk_exists"] = put_blk(proto["blk_exists"], torch.tensor(True, device=to.device))
        proto["blk_time"] = put_blk(proto["blk_time"], torch.tensor(t, device=to.device))
        proto["blk_parent"] = put_blk(proto["blk_parent"], proto["head_slot"])
        emissions.append(
            self._emission(bp_sel, self.bp_ids, self.att_ids, "PROPOSAL", new_slot,
                           send_time=t + p.block_construction_time)
        )

        # attester committee selection (:238-253)
        att_sel = (
            trig
            & self.is_att
            & (rd % p.attesters_round == self.my_round)
            & ~_get_one(proto["cm_h"], rbr_h.clamp(0, mh + 1).long())
        )
        proto["vote_for_h"] = torch.where(att_sel, rbr_h, proto["vote_for_h"])

        # beacon: adopt a beacon someone else finished (:308-313)
        bcn_fwd = trig & self.is_bcn & (rbr_h > proto["bcn_height"])
        proto["bcn_last_sent"] = torch.where(bcn_fwd, proto["bcn_height"], proto["bcn_last_sent"])
        proto["bcn_height"] = torch.where(bcn_fwd, rbr_h, proto["bcn_height"])

        # ---- C+D. proposals (arrived + unbuffered) and votes --------------
        prop_ev = _or_at(r, n * mb, cell, is_prop).view(r, n, mb)
        # onRandomBeaconOnce replays buffered proposals at the new height
        # then clears the buffer (:243-253)
        at_vh = h_of == proto["vote_for_h"][..., None]
        prop_ev = prop_ev | (att_sel[..., None] & proto["prop_buf"] & at_vh)
        proto["prop_buf"] = proto["prop_buf"] & ~att_sel[..., None]

        votable = is_att_c & at_vh
        do_vote = prop_ev & votable & ~proto["self_voted"]
        proto["self_voted"] = proto["self_voted"] | do_vote
        # buffer future proposals (:225-227)
        buf = prop_ev & is_att_c & ~votable & (
            h_of > self._head_h(proto["head_slot"])[..., None]
        )
        proto["prop_buf"] = proto["prop_buf"] | buf

        # the broadcast includes the sender (send_all semantics); the oracle
        # drops the self copy via its voter set (:197-199) — here the self
        # vote is already counted by do_vote
        vote_ev = torch.zeros((r, n * mb), dtype=torch.int32, device=to.device).scatter_add(
            1, cell, (is_vote & (frm != to)).to(torch.int32)
        ).view(r, n, mb)
        vote_ev = torch.where(votable, vote_ev, 0)  # on_vote height guard (:194-200)
        proto["vote_cnt"] = proto["vote_cnt"] + vote_ev + do_vote.to(torch.int32)

        # majority crossings -> notarize ONE block per attester (:202-206)
        crossing = votable & (proto["vote_cnt"] >= p.majority) & (do_vote | (vote_ev > 0))
        cross_key = torch.where(crossing, mb - slots, 0)
        cw = torch.argmax(cross_key, dim=-1)  # first max, as jnp.argmax
        has_cross = cross_key.amax(-1) > 0
        proto["cm_blk"] = _set_one(proto["cm_blk"], cw, _get_one(proto["cm_blk"], cw) | has_cross)
        ch = self._slot_h(cw).clamp(0, mh + 1)
        proto["cm_h"] = _set_one(proto["cm_h"], ch, _get_one(proto["cm_h"], ch) | has_cross)
        proto["vote_for_h"] = torch.where(has_cross, -1, proto["vote_for_h"])
        emissions.append(
            self._emission(has_cross, self.att_ids, self.all_ids, "SEND_BLOCK",
                           cw.to(torch.int32))
        )

        # non-crossing self-votes broadcast Vote to the committee (:216-224);
        # once an attester notarizes, its remaining same-tick votes are
        # dropped (the oracle's sequential processing stops at _send_block's
        # voteForHeight reset)
        vote_out = do_vote & ~has_cross[..., None]
        vh = proto["vote_for_h"].clamp(1, mh)
        for j in range(self.n_bp):
            # at most one votable height per attester -> n_bp candidate slots
            sl = ((vh - 1) * self.n_bp + j).clamp(0, mb - 1)
            m = _get_one(vote_out, sl.long()) & self.is_att
            emissions.append(
                self._emission(m, self.att_ids, self.att_ids, "VOTE", sl,
                               send_time=t + p.attestation_construction_time)
            )

        # ---- E. beacon exchanges (:266-272) -------------------------------
        # self copy dropped: the sender added itself at height advance
        # (exchanged set dedup, Dfinity.java:268-271)
        rbe_ok = (
            is_rbe
            & (frm != to)
            & self.is_bcn[to.long()]
            & (payh >= take(proto["bcn_height"], to))
            & (payh > take(proto["bcn_last_sent"], to))
        )
        proto["exch_cnt"] = proto["exch_cnt"].reshape(r, -1).scatter_add(
            1, to.long() * (mh + 2) + payh.long(), rbe_ok.to(torch.int32)
        ).view(r, n, mh + 2)
        rb_now_b = (
            self.is_bcn
            & (_get_one(proto["exch_cnt"], proto["bcn_height"].clamp(0, mh + 1).long()) >= p.majority)
            & (proto["bcn_height"] > proto["bcn_last_sent"])
            & (_or_at(r, n, to.long(), rbe_ok) | rb_now_a)
        )
        proto["bcn_last_sent"] = torch.where(rb_now_b, proto["bcn_height"], proto["bcn_last_sent"])
        emissions.append(
            self._emission(rb_now_b, self.bcn_ids, self.all_ids, "RBR", proto["bcn_height"],
                           proto["bcn_height"], send_time=t + p.attestation_construction_time)
        )

        return state._replace(proto=proto), emissions

    def all_done(self, state):
        # Dfinity runs open-ended, like the oracle
        return torch.zeros(state.down.shape[0], dtype=torch.bool, device=state.down.device)

    def head_height(self, state):
        """Per-node head height (the print_stat observable), [R, N]."""
        return self._head_h(state.proto["head_slot"])


def make_dfinity(
    params: Optional[DfinityParameters] = None,
    max_heights: int = 64,
    capacity: int = 1 << 13,
    seed: int = 0,
    latency_name: Optional[str] = None,
    device=None,  # None = CUDA; "cpu" runs the plain versions
):
    """Host-side construction: the oracle's node population (same RNG
    stream — observer, attesters, producers, beacons in id order) baked
    into the engine on the default 512-row wheel; returns (net,
    single-replica state)."""
    dev = resolve_device(device)
    params = params or DfinityParameters()
    nodes, roles = dfinity_population(params)
    n = len(nodes)
    # the reference never applies networkLatencyName (Dfinity.java:86-90);
    # callers pick the model explicitly, like DfinityTest does
    latency = registry_network_latencies.get_by_name(latency_name)
    cols = build_node_columns(nodes, getattr(latency, "city_index", None))
    proto = BatchedDfinity(params, roles, max_heights, device=dev)
    net = BatchedNetwork(proto, latency, n, capacity=capacity, device=dev)
    state = net.init_state(cols, seed=seed, proto=proto.proto_init(n))
    return net, state
