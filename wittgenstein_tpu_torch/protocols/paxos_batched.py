"""Batched classic Paxos, ported to PyTorch.

A line-for-line port of the JAX package's protocols/paxos_batched.py —
its module docstring gives the model: acceptors and proposers as
per-node columns, `Optional[int]` as -1, in-progress counters capped at
the majority so a crossing fires once, same-tick PROPOSE/COMMIT batches
judged against the pre-tick acceptor state, and proposer timeouts as
size-0 TIMEOUT self-messages with explicit arrivals.  What changes here
is representation only:

  * every tensor carries the replica axis R in front ([R, N]);
  * the clock `t` is the engine's host int;
  * `deliver` first compacts the delivered rows of the view (one device
    read, `ops.indexing.live_rows`) and works on those: the replies are
    per-row emissions, and their live rows keep the order of the view's,
    so the store receives them in the same slots;
  * `.at[to].max` / `.add` become `scatter_reduce` amax / `scatter_add`
    over the live rows, whose padding rows carry the identity (-1 or 0).

Paxos is event-driven (TICK_INTERVAL None) on the 512-row wheel: each
jump reads the wheel's occupancy through `pack_occupied` and
`lowest_set_bit`, and with `stop_when_done` the loop's quiescence test
counts it with `popcount_words`.  The 1000-ms timeouts lie past the
wheel's horizon and wait in the overflow lane.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.node import build_node_columns
from ..core.registries import registry_network_latencies
from ..engine.core import BatchedNetwork, Emission, resolve_device
from ..engine.protocol import BatchedProtocol
from ..ops.indexing import live_rows, take
from .paxos import PaxosParameters, paxos_roles

NONE = -1
# packed (acceptedSeq, acceptedVal) scatter-max key; val < MAX_VAL=1000 < 2048
VAL_PACK = 2048


def _max_at(col: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Functional `col.at[idx].max(vals)` per replica: col [R, N], idx and
    vals [R, M]."""
    return col.scatter_reduce(1, idx.to(torch.int64), vals.to(col.dtype), reduce="amax",
                              include_self=True)


class BatchedPaxos(BatchedProtocol):
    MSG_TYPES = ["PROPOSE", "REJECT", "AGREE", "COMMIT", "ACCEPT", "REJECT2", "TIMEOUT"]
    PAYLOAD_WIDTH = 3  # AGREE carries (yourSeq, acceptedSeq, acceptedVal)
    TICK_INTERVAL = None

    def __init__(self, params: PaxosParameters, roles: dict, device=None):
        self.params = params
        self.majority = params.acceptor_count // 2 + 1
        self.n_acc = params.acceptor_count
        self.n_prop = params.proposer_count
        self.n_nodes = self.n_acc + self.n_prop
        dev = resolve_device(device)

        def i32(a):
            return torch.as_tensor(a, dtype=torch.int32, device=dev)

        self.is_acc = torch.as_tensor(roles["is_acc"], device=dev)
        self.is_prop = torch.as_tensor(roles["is_prop"], device=dev)
        self.rank = i32(roles["rank"])
        self.value_proposed = i32(roles["value_proposed"])
        self.acc_ids = i32(roles["acc_ids"])
        self.prop_ids = i32(roles["prop_ids"])

    def msg_size(self, mtype: int) -> int:
        return 0 if self.MSG_TYPES[mtype] == "TIMEOUT" else 1

    def proto_init(self, n_nodes: int):
        dev = self.rank.device

        def zi():
            return torch.zeros(n_nodes, dtype=torch.int32, device=dev)

        def none():
            return torch.full((n_nodes,), NONE, dtype=torch.int32, device=dev)

        # the init-time startNextProposal is pre-applied: first seq is
        # proposerCount + rank (seqAccepted=0, seqIP=0 path, :329-333);
        # initial_emissions builds the matching PROPOSE + TIMEOUT rows
        first_seq = torch.where(self.is_prop, self.params.proposer_count + self.rank, 0)
        return {
            # acceptor columns (Paxos.java:153-160)
            "max_agreed": none(),
            "acc_seq": none(),
            "acc_val": none(),
            # proposer columns (:209-240)
            "seq_ip": first_seq.to(torch.int32),
            "prop_ip": self.is_prop.clone(),
            "seq_accepted": zi(),
            "asi": none(),  # acceptedSeqIP
            "avi": none(),  # acceptedValIP
            "agree_ip": zi(),
            "rej1_ip": zi(),
            "accept_ip": zi(),
            "rej2_ip": zi(),
            "value_accepted": none(),
            "agree_count": zi(),
            "rej1_count": zi(),
            "rej2_count": zi(),
            "timeout_count": zi(),
        }

    def _all_pairs(self, mask_col, col, mtype: str, col1=None):
        """An emission from every proposer to every acceptor (proposer-major,
        jnp.repeat / jnp.tile order) of per-proposer [R, N] columns."""
        def rep(c):
            return c[:, self.prop_ids.long()].repeat_interleave(self.n_acc, dim=1)

        p0 = rep(col)
        p1 = rep(col1) if col1 is not None else torch.zeros_like(p0)
        return Emission(
            mask=rep(mask_col),
            from_idx=self.prop_ids.repeat_interleave(self.n_acc),
            to_idx=self.acc_ids.repeat(self.n_prop),
            mtype=self.mtype(mtype),
            payload=torch.stack([p0, p1, torch.zeros_like(p0)], dim=-1),
        )

    def _proposal_emissions(self, seq_ip, mask, t: int):
        """PROPOSE to every acceptor + the timeout self-message, shared by
        the init path and round restarts (sent at t+1; timeout at
        t+1+timeout, :329-338)."""
        pid = self.prop_ids.long()
        seq = seq_ip[:, pid]
        zero = torch.zeros_like(seq)
        em_tmo = Emission(
            mask=mask[:, pid],
            from_idx=self.prop_ids,
            to_idx=self.prop_ids,
            mtype=self.mtype("TIMEOUT"),
            payload=torch.stack([seq, zero, zero], dim=-1),
            arrival=torch.full_like(seq, t + 1 + self.params.timeout),
        )
        return [self._all_pairs(mask, seq_ip, "PROPOSE"), em_tmo]

    # -- proposer round start (startNextProposal, :313-338) ------------------
    def _start_proposals(self, t: int, mask, proto):
        """Reset in-progress state, pick the next seq, PROPOSE to every
        acceptor and arm the timeout self-message."""
        pc = self.params.proposer_count
        # floor modulo, as jnp's %: seq_accepted is never negative anyway
        gap = torch.remainder(proto["seq_accepted"], pc)
        cand = proto["seq_accepted"] + pc - gap + self.rank
        new_seq = torch.where(cand > proto["seq_ip"], cand, proto["seq_ip"] + pc)
        seq_ip = torch.where(mask, new_seq, proto["seq_ip"]).to(torch.int32)
        proto = dict(proto, seq_ip=seq_ip, prop_ip=proto["prop_ip"] | mask)
        for k, v in (("asi", NONE), ("avi", NONE), ("agree_ip", 0), ("rej1_ip", 0),
                     ("accept_ip", 0), ("rej2_ip", 0)):
            proto[k] = torch.where(mask, v, proto[k]).to(torch.int32)
        return proto, self._proposal_emissions(seq_ip, mask, t)

    def initial_emissions(self, net, state):
        """init: every proposer's first PROPOSE (sent at t=1) and its
        timeout — the state side is pre-baked in proto_init."""
        r = state.proto["seq_ip"].shape[0]
        return self._proposal_emissions(
            state.proto["seq_ip"], self.is_prop.expand(r, -1), 0
        )

    def deliver(self, net, state, deliver_mask, t: int):
        proto = dict(state.proto)
        r, n = deliver_mask.shape[0], self.n_nodes
        dev = deliver_mask.device
        (rows,) = live_rows([deliver_mask])
        if rows is None:  # nothing delivered in any replica: empty rows
            idx = torch.zeros((r, 0), dtype=torch.int64, device=dev)
            live = torch.zeros((r, 0), dtype=torch.bool, device=dev)
        else:
            idx, live = rows

        def col(c):
            return torch.gather(c, 1, idx)

        to, frm, mt = col(state.msg_to), col(state.msg_from), col(state.msg_type)
        pay = torch.gather(state.msg_payload, 1, idx[..., None].expand(-1, -1, 3))
        seq_p, p1, p2 = pay[..., 0], pay[..., 1], pay[..., 2]

        def m_(name):
            return live & (mt == self.mtype(name))

        is_pro, is_rej, is_agr = m_("PROPOSE"), m_("REJECT"), m_("AGREE")
        is_com, is_acc, is_rj2 = m_("COMMIT"), m_("ACCEPT"), m_("REJECT2")
        is_tmo = m_("TIMEOUT")
        emissions = []

        # ---- acceptors: onPropose (:163-177) ------------------------------
        ma = proto["max_agreed"]
        ma_to = take(ma, to)
        agree = is_pro & (seq_p > ma_to)
        reject = is_pro & (seq_p < ma_to)
        emissions.append(
            Emission(  # per-row replies against pre-tick acceptor state
                mask=agree | reject,
                from_idx=to,
                to_idx=frm,
                mtype=torch.where(agree, self.mtype("AGREE"), self.mtype("REJECT")),
                payload=torch.stack(
                    [
                        seq_p,
                        torch.where(agree, take(proto["acc_seq"], to), ma_to),
                        torch.where(agree, take(proto["acc_val"], to), 0),
                    ],
                    dim=-1,
                ),
            )
        )
        proto["max_agreed"] = _max_at(ma, to, torch.where(agree, seq_p, NONE))

        # ---- acceptors: onCommit (:179-192) -------------------------------
        acc_val_to = take(proto["acc_val"], to)
        ok_com = is_com & (seq_p == ma_to) & ((acc_val_to == NONE) | (acc_val_to == p1))
        rj_com = is_com & ~ok_com
        emissions.append(
            Emission(
                mask=ok_com | rj_com,
                from_idx=to,
                to_idx=frm,
                mtype=torch.where(ok_com, self.mtype("ACCEPT"), self.mtype("REJECT2")),
                payload=torch.stack(
                    [seq_p, torch.where(ok_com, 0, ma_to), torch.zeros_like(seq_p)], dim=-1
                ),
            )
        )
        # acceptedVal and acceptedSeq are maxed independently, as in JAX
        proto["acc_val"] = _max_at(proto["acc_val"], to, torch.where(ok_com, p1, NONE))
        proto["acc_seq"] = _max_at(proto["acc_seq"], to, torch.where(ok_com, seq_p, NONE))

        # ---- proposers: count replies for the current seq -----------------
        live_p = take(proto["prop_ip"], to) & (seq_p == take(proto["seq_ip"], to))
        to64 = to.to(torch.int64)

        def count(mask_rows, name):
            arr = torch.zeros((r, n), dtype=torch.int32, device=dev).scatter_add(
                1, to64, (mask_rows & live_p).to(torch.int32)
            )
            return torch.clamp(proto[name] + arr, max=self.majority)

        old_agree, old_rej1 = proto["agree_ip"], proto["rej1_ip"]
        old_accept, old_rej2 = proto["accept_ip"], proto["rej2_ip"]
        proto["agree_ip"] = count(is_agr, "agree_ip")
        proto["rej1_ip"] = count(is_rej, "rej1_ip")
        proto["accept_ip"] = count(is_acc, "accept_ip")
        proto["rej2_ip"] = count(is_rj2, "rej2_ip")

        # AGREE (acceptedSeq, acceptedVal) bookkeeping: same-tick max
        # (:255-259), gated on the pre-majority count like the oracle's
        # `agree_count_ip < majority` entry guard
        has_prev = is_agr & live_p & (p1 != NONE) & (take(old_agree, to) < self.majority)
        pack = _max_at(
            torch.full((r, n), -1, dtype=torch.int32, device=dev), to,
            torch.where(has_prev, p1 * VAL_PACK + torch.clamp(p2, 0, VAL_PACK - 1), -1),
        )
        p_seq = torch.div(pack, VAL_PACK, rounding_mode="floor")
        better = (pack >= 0) & ((proto["asi"] == NONE) | (p_seq > proto["asi"]))
        proto["asi"] = torch.where(better, p_seq, proto["asi"])
        proto["avi"] = torch.where(better, torch.remainder(pack, VAL_PACK), proto["avi"])

        # rejection seq feedback: seqAccepted = max(seqAccepted, serverSeq)
        rej_seq = _max_at(torch.zeros((r, n), dtype=torch.int32, device=dev), to,
                          torch.where((is_rej | is_rj2) & live_p, p1, 0))

        maj = self.majority

        def cross(old, new):
            return (old < maj) & (new >= maj)

        agree_x = cross(old_agree, proto["agree_ip"])
        rej1_x = cross(old_rej1, proto["rej1_ip"])
        accept_x = cross(old_accept, proto["accept_ip"])
        rej2_x = cross(old_rej2, proto["rej2_ip"])

        # onAgree majority: commit the learned or own value (:260-268)
        proto["agree_count"] = proto["agree_count"] + agree_x.to(torch.int32)
        avi = torch.where(agree_x & (proto["avi"] == NONE), self.value_proposed, proto["avi"])
        proto["avi"] = avi
        emissions.append(self._all_pairs(agree_x, proto["seq_ip"], "COMMIT", avi))

        # onAccept majority: value accepted, node done (:269-280)
        newly_done = accept_x & (proto["value_accepted"] == NONE)
        proto["value_accepted"] = torch.where(newly_done, avi, proto["value_accepted"])
        proto["prop_ip"] = proto["prop_ip"] & ~(accept_x | rej1_x | rej2_x)
        state = state._replace(done_at=torch.where(newly_done, max(t, 1), state.done_at))

        # timeout while still in progress (:305-310): a bool scatter-max
        tmo_fire = torch.zeros((r, n), dtype=torch.int32, device=dev).scatter_add(
            1, to64, (is_tmo & live_p).to(torch.int32)) > 0
        tmo_fire = tmo_fire & proto["prop_ip"] & ~(agree_x | accept_x)
        proto["timeout_count"] = proto["timeout_count"] + tmo_fire.to(torch.int32)

        # rejected or timed out -> next round (:244-249, :281-288)
        proto["rej1_count"] = proto["rej1_count"] + rej1_x.to(torch.int32)
        proto["rej2_count"] = proto["rej2_count"] + rej2_x.to(torch.int32)
        proto["seq_accepted"] = torch.where(
            rej1_x | rej2_x, torch.maximum(proto["seq_accepted"], rej_seq), proto["seq_accepted"]
        )
        restart = (rej1_x | rej2_x | tmo_fire) & (proto["value_accepted"] == NONE)
        proto["prop_ip"] = proto["prop_ip"] & ~restart
        proto, ems2 = self._start_proposals(t, restart, proto)
        emissions += ems2

        return state._replace(proto=proto), emissions

    def all_done(self, state):
        return torch.where(self.is_prop, state.proto["value_accepted"] != NONE, True).all(-1)


def make_paxos(
    params: Optional[PaxosParameters] = None,
    capacity: int = 1 << 11,
    seed: int = 0,
    device=None,  # None = CUDA; "cpu" runs the plain versions
):
    """Host-side construction from the oracle's node population (same
    JavaRandom stream: positions AND each proposer's valueProposed) on
    the default 512-row wheel; returns (net, single-replica state)."""
    dev = resolve_device(device)
    params = params or PaxosParameters()
    nodes, roles = paxos_roles(params)
    n = len(nodes)
    latency = registry_network_latencies.get_by_name(params.latency)
    cols = build_node_columns(nodes, getattr(latency, "city_index", None))
    proto = BatchedPaxos(params, roles, device=dev)
    net = BatchedNetwork(proto, latency, n, capacity=capacity, device=dev)
    state = net.init_state(cols, seed=seed, proto=proto.proto_init(n))
    return net, state
