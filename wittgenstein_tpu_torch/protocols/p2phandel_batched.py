"""Batched P2PHandel: Handel-style aggregation over a generic P2P graph,
ported to PyTorch.

A method-for-method port of the JAX package's
protocols/p2phandel_batched.py — its module docstring gives the model in
full (dense signature sets `verified [N, N]`, the pending pool, the
per-peer knowledge cube `peers_state [N, P, N]`, the periodic push of the
largest diff as an N/32-word payload, both checkSigs strategies with a
single verification register, State broadcasts, the ver_card cache).
What changes here is representation only:

  * every tensor carries the replica axis R in front ([R, N, ...]);
  * the clock `t` is the engine's host int, so the sendSigs beat is a
    host test and the [R, N, P, N] diff is formed on beat ticks only;
  * work whose every row is masked is skipped, with one device read a
    tick each in `deliver` and `tick`: delivery runs on the delivered
    rows of the view only, the final aggregation's [R, N, P] peer
    cardinalities are formed only on ticks where some node reaches the
    threshold, and an [R, N * P] emission with no live row goes out with
    no rows (it still takes its send counter).  A masked row changes no
    state in the JAX package either, so the state is the same;
  * `_pack` is the hand-written `pack_bool_words`: bit j of word k is
    element 32k + j, zero-padded — what the JAX package's weighted sum
    computes;
  * `.at[to, slot].max(bool)` scatters, whose destinations may repeat
    within a tick, are an `index_reduce` amax over uint8 views of the
    bool rows (an OR that does not depend on the order of duplicates);
    dropped rows write zeros;
  * the three emissions of a tick go through one `apply_emissions` call
    in the JAX package's order, each with its own send counter.

Every phase is bit-identical to the JAX package
(tests/test_torch_p2phandel.py).
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from ..core.node import build_node_columns
from ..core.registries import registry_network_latencies
from ..engine.core import BatchedNetwork, Emission, resolve_device
from ..engine.density import NarrowLeaf, narrowest_int
from ..engine.protocol import BatchedProtocol
from ..ops.bitops import pack_bool_words
from .p2phandel import P2PHandelParameters, p2phandel_population


def _or_rows(base: torch.Tensor, idx: torch.Tensor, keep: torch.Tensor,
             rows: torch.Tensor) -> torch.Tensor:
    """Functional `base.at[idx].max(rows, mode="drop")` over bool rows:
    base [M, N], idx [Q] row ids in range, keep [Q] the rows that write,
    rows [Q, N].  Rows that repeat an index OR together; a dropped row ORs
    zeros, a no-op."""
    out = base.clone().view(torch.uint8)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="index_reduce")
        out.index_reduce_(0, idx.to(torch.int64), (rows & keep[:, None]).view(torch.uint8),
                          "amax")
    return out.view(torch.bool)


class BatchedP2PHandel(BatchedProtocol):
    MSG_TYPES = ["SEND_SIGS", "STATE"]
    TICK_INTERVAL = 1  # periodic beat + conditional checkSigs per ms
    CAND_K = 8  # checkSigs1 to_verify pool depth
    # ver_card cache: `verified` changes only in tick's commit, so one
    # carried int32[N] cardinality replaces the two [N, N] reductions per
    # tick; bit-identical either way
    SCORE_CACHE = True

    def __init__(self, params: P2PHandelParameters, adjacency: np.ndarray, just_relay,
                 device=None):
        dev = resolve_device(device)
        self.params = params
        self.n_nodes = params.signing_node_count + params.relaying_node_count
        self.adj = torch.as_tensor(np.asarray(adjacency, np.int32), device=dev)
        self.n_peers = self.adj.shape[1]
        self.adj_ok = self.adj >= 0  # [N, P]
        self.adj_to = torch.clamp(self.adj, min=0)
        self.just_relay = torch.as_tensor(np.asarray(just_relay, bool), device=dev)
        self.PAYLOAD_WIDTH = (self.n_nodes + 31) // 32
        self.NARROW_LEAVES = self._narrow_plan()

    def _narrow_plan(self) -> tuple:
        """ver_card is a verified-signature cardinality, <= N: carried
        narrow, computed in int32 inside the widen/narrow hook boundary
        (the JAX package's plan; inert when the leaf is absent)."""
        dt = narrowest_int(self.n_nodes)
        if dt.itemsize >= 4:
            return ()
        return (NarrowLeaf("ver_card", dt.name, self.n_nodes),)

    def msg_size(self, mtype: int) -> int:
        return 1  # dynamic in the reference; see the JAX module docstring

    def _pack(self, bits):
        """bool[..., N] -> [..., W] int32 payload words (bit j of word k is
        element 32k + j, zero-padded)."""
        return pack_bool_words(bits)

    def _unpack(self, words):
        """int32 words [..., W] -> bool[..., N]."""
        ar = torch.arange(32, dtype=torch.int32, device=words.device)
        bits = (words[..., None] >> ar) & 1  # the & keeps bit j of the word
        bits = bits.reshape(words.shape[:-1] + (self.PAYLOAD_WIDTH * 32,))
        return bits[..., : self.n_nodes] == 1

    def proto_init(self, n_nodes: int, device=None):
        """Protocol state for one replica (no leading replica axis)."""
        dev = resolve_device(device)
        n = self.n_nodes
        # signing nodes hold their own signature (ctor, :264-266)
        verified = torch.diag(~self.just_relay.to(dev))
        proto = {
            "verified": verified,
            "pend": torch.zeros((n, n), dtype=torch.bool, device=dev),
            "peers_state": torch.zeros((n, self.n_peers, n), dtype=torch.bool, device=dev),
            "ver_active": torch.zeros(n, dtype=torch.bool, device=dev),
            "ver_done_t": torch.zeros(n, dtype=torch.int32, device=dev),
            "ver_sig": torch.zeros((n, n), dtype=torch.bool, device=dev),
            "last_check": torch.zeros(n, dtype=torch.int32, device=dev),
        }
        if not self.params.double_aggregate_strategy:
            proto["cand"] = torch.zeros((n, self.CAND_K, n), dtype=torch.bool, device=dev)
        if self.SCORE_CACHE:
            proto["ver_card"] = verified.sum(-1).to(torch.int32)
        return self.narrow_proto(proto)

    def _to_peers(self, mask, mtype: str, packed, any_row: bool = True) -> Emission:
        """One message to every peer of each node: mask [R, N, P]; packed
        [R, N, W] payload words, the same for every peer of a node.  With
        any_row False (the caller knows the mask is all false) the
        emission has no rows: it still takes its send counter, and a
        masked row would change nothing else."""
        r = mask.shape[0]
        if not any_row:
            return Emission.no_rows(r, self.mtype(mtype), self.PAYLOAD_WIDTH, mask.device)
        ids = torch.arange(self.n_nodes, dtype=torch.int32, device=mask.device)
        return Emission(
            mask=mask.reshape(r, -1),
            from_idx=torch.repeat_interleave(ids, self.n_peers),
            to_idx=self.adj_to.reshape(-1),
            mtype=self.mtype(mtype),
            payload=torch.repeat_interleave(packed, self.n_peers, dim=1),
        )

    def initial_emissions(self, net, state):
        if not self.params.send_state:
            return []
        # init registers sendStateToPeers at t=1 for every node (:497-501)
        r = state.down.shape[0]
        em = self._to_peers(
            self.adj_ok.expand(r, -1, -1), "STATE", self._pack(state.proto["verified"])
        )
        em.send_time = 1
        return [em]

    # -- message handling ----------------------------------------------------
    def deliver(self, net, state, deliver_mask, t: int):
        # NARROW_LEAVES boundary: hook bodies compute on the int32 view
        state = state._replace(proto=self.widen_proto(state.proto))
        state, ems = self._deliver_impl(net, state, deliver_mask)
        return state._replace(proto=self.narrow_proto(state.proto)), ems

    def _deliver_impl(self, net, state, deliver_mask):
        proto = dict(state.proto)
        n, npr = self.n_nodes, self.n_peers
        r, d = deliver_mask.shape
        # only the delivered rows of the view (a few of its wheel-row and
        # overflow slots) do anything below: one device read finds them
        sel = deliver_mask.reshape(-1).nonzero().squeeze(1)
        to = state.msg_to.reshape(-1)[sel].to(torch.int64)
        frm = state.msg_from.reshape(-1)[sel]
        sigs = self._unpack(state.msg_payload.reshape(r * d, -1)[sel])  # [Q, N]
        is_ss = state.msg_type.reshape(-1)[sel] == self.mtype("SEND_SIGS")
        node_row = torch.div(sel, d, rounding_mode="floor") * n + to  # replica-major node row

        # peers_state[to, slot(frm)] |= sigs — both SendSigs (onNewSig,
        # :330-334) and State (onPeerState, :281-283) fold in here
        adj_to = self.adj[to]  # [Q, P]
        slot_of = torch.argmax((adj_to == frm[:, None]).to(torch.uint8), dim=-1)
        ok = torch.gather(adj_to, -1, slot_of[:, None])[:, 0] == frm
        proto["peers_state"] = _or_rows(
            proto["peers_state"].reshape(r * n * npr, n), node_row * npr + slot_of, ok, sigs
        ).view(r, n, npr, n)
        ss = is_ss & ok
        if self.params.double_aggregate_strategy:
            # checkSigs2 pool: one OR-aggregate
            proto["pend"] = _or_rows(proto["pend"].reshape(r * n, n), node_row, ss, sigs).view(
                r, n, n
            )
        else:
            # checkSigs1 pool: same-ms arrivals merge into ONE new entry,
            # which replaces the least-valuable slot if it adds more
            arrivals = _or_rows(
                torch.zeros((r * n, n), dtype=torch.bool, device=sel.device), node_row, ss, sigs
            ).view(r, n, n)
            has_new = torch.any(arrivals, dim=-1)
            cand = proto["cand"]
            verified = proto["verified"]
            v_k = (cand & ~verified[:, :, None, :]).sum(-1)  # [R, N, K]
            worst = torch.argmin(v_k, dim=-1)
            v_min = torch.gather(v_k, -1, worst[..., None])[..., 0]
            v_new = (arrivals & ~verified).sum(-1)
            insert = has_new & (v_new > v_min)
            ks = torch.arange(self.CAND_K, device=sel.device)
            put = insert[..., None] & (ks == worst[..., None])  # [R, N, K]
            proto["cand"] = torch.where(put[..., None], arrivals[:, :, None, :], cand)
        return state._replace(proto=proto), []

    # -- per-tick ------------------------------------------------------------
    def tick(self, net, state, t: int):
        state = state._replace(proto=self.widen_proto(state.proto))
        state = self._tick_impl(net, state, t)
        return state._replace(proto=self.narrow_proto(state.proto))

    def _tick_impl(self, net, state, t: int):
        p = self.params
        proto = dict(state.proto)
        n, npr = self.n_nodes, self.n_peers
        r = state.done_at.shape[0]
        dev = state.done_at.device
        ids = torch.arange(n, dtype=torch.int32, device=dev)
        verified = proto["verified"]
        ps = proto["peers_state"]

        # 1. commit due verifications (updateVerifiedSignatures, :290-303)
        due = proto["ver_active"] & (t >= proto["ver_done_t"])
        if self.SCORE_CACHE:
            # carried cardinality + the union identity: one [N, N]
            # reduction (the delta) instead of two full recounts
            old_card = proto["ver_card"]
            delta = (proto["ver_sig"] & ~verified).sum(-1).to(torch.int32)
            verified = torch.where(due[..., None], verified | proto["ver_sig"], verified)
            new_card = torch.where(due, old_card + delta, old_card)
            proto["ver_card"] = new_card
        else:
            old_card = verified.sum(-1)
            verified = torch.where(due[..., None], verified | proto["ver_sig"], verified)
            new_card = verified.sum(-1)
        grew = due & (new_card > old_card)
        was_undone = state.done_at == 0
        reach = grew & was_undone & (new_card >= p.threshold)
        state = state._replace(done_at=torch.where(reach, t, state.done_at))
        proto["ver_active"] = proto["ver_active"] & ~due

        # improving, non-final commit: broadcast State to all peers
        # (updateVerifiedSignatures elif branch, :299-301)
        st = grew & was_undone & ~reach
        # one device read: does any node reach the threshold, or broadcast
        # its state, this tick?  Without one, the final aggregation's
        # [R, N, P] cardinalities are not formed and the [R, N * P]
        # emissions go out without rows
        any_reach, any_state = torch.stack([reach.any(), st.any()]).tolist()

        # final aggregation to peers still short of threshold (:305-317)
        fin = torch.zeros((r, n, npr), dtype=torch.bool, device=dev)
        if any_reach:
            needy = (ps.sum(-1) < p.threshold) & self.adj_ok  # [R, N, P]
            fin = reach[..., None] & needy
            ps = torch.where(fin[..., None], ps | verified[:, :, None, :], ps)
        packed = self._pack(verified)  # [R, N, W]
        ems = [self._to_peers(fin, "SEND_SIGS", packed, any_reach)]
        if p.send_state:
            ems.append(self._to_peers(st[..., None] & self.adj_ok, "STATE", packed, any_state))

        # 2. checkSigs beat: conditional task, min gap pairingTime
        # (init :505-509), single verification register; reads same-tick
        # state, as the JAX package does (its comment gives the lead)
        gate = (state.done_at == 0) & ~proto["ver_active"] & (t - proto["last_check"] >= p.pairing_time)
        if t < 1:
            gate = torch.zeros_like(gate)
        if p.double_aggregate_strategy:
            # checkSigs2 (:455-479): aggregate everything, verify once
            agg = proto["pend"]
            check = torch.any(agg, dim=-1) & gate
            useful = torch.any(agg & ~verified, dim=-1) & check
            proto["pend"] = torch.where(check[..., None], False, agg)
            chosen = agg
        else:
            # checkSigs1 (:419-447): prune zero-value entries, verify the
            # single best
            cand = proto["cand"]
            v_k = (cand & ~verified[:, :, None, :]).sum(-1)  # [R, N, K]
            occupied = torch.any(cand, dim=-1)
            cand = cand & (v_k > 0)[..., None]  # iterator discard
            check = torch.any(occupied, dim=-1) & gate
            best = torch.argmax(v_k, dim=-1)
            best_v = torch.gather(v_k, -1, best[..., None])[..., 0]
            useful = check & (best_v > 0)
            chosen = torch.gather(cand, 2, best[:, :, None, None].expand(r, n, 1, n))[:, :, 0]
            ks = torch.arange(self.CAND_K, device=dev)
            clear = useful[..., None] & (ks == best[..., None])
            proto["cand"] = torch.where(clear[..., None], False, cand)
        proto["last_check"] = torch.where(check, t, proto["last_check"])
        proto["ver_active"] = proto["ver_active"] | useful
        proto["ver_done_t"] = torch.where(useful, t + 2 * p.pairing_time, proto["ver_done_t"])
        proto["ver_sig"] = torch.where(useful[..., None], chosen, proto["ver_sig"])

        # 3. periodic sendSigs: push the largest diff (:336-354); off the
        # beat nothing is sent and peers_state stays as it is
        dest = self.adj_to[:, 0].expand(r, n)
        payload = packed
        send = torch.zeros_like(was_undone)
        if t >= 1 and (t - 1) % p.sigs_send_period == 0:
            beat = was_undone & ~state.down
            diff = verified[:, :, None, :] & ~ps  # [R, N, P, N]
            dsz = (diff & self.adj_ok[..., None]).sum(-1)
            best = torch.argmax(dsz, dim=-1)  # [R, N]
            best_sz = torch.gather(dsz, -1, best[..., None])[..., 0]
            send = beat & (best_sz > 0)
            dest = torch.gather(self.adj_to.expand(r, n, npr), -1, best[..., None])[..., 0]
            if p.strategy.value == "dif":
                # the diff goes on the wire for plain "dif" only; all /
                # cmp_all / cmp_diff ship the full verified set
                payload = self._pack(
                    torch.gather(diff, 2, best[:, :, None, None].expand(r, n, 1, n))[:, :, 0]
                )
            slot = send[..., None] & (torch.arange(npr, device=dev) == best[..., None])
            ps = torch.where(slot[..., None], ps | verified[:, :, None, :], ps)
        em_push = Emission(
            mask=send, from_idx=ids, to_idx=dest, mtype=self.mtype("SEND_SIGS"), payload=payload
        )

        proto["verified"] = verified
        proto["peers_state"] = ps
        state = state._replace(proto=proto)
        return net.apply_emissions(state, [em_push] + ems, t)

    def all_done(self, state):
        """bool[R]: every live node of the replica has aggregated."""
        return torch.all(state.down | (state.done_at > 0), dim=-1)


def make_p2phandel(
    params: Optional[P2PHandelParameters] = None,
    capacity: int = 1 << 13,
    seed: int = 0,
    score_cache: bool = True,
    device=None,  # None = CUDA; "cpu" runs the plain versions
):
    """Host-side construction: P2PHandel.init's relay draw, nodes and
    graph from the same JavaRandom stream (protocols/p2phandel.py), on the
    engine's default 512-row time wheel; returns (net, single-replica
    state).  `score_cache=False` drops the carried ver_card cardinality."""
    dev = resolve_device(device)
    params = params or P2PHandelParameters()
    nodes, adj, just_relay = p2phandel_population(params)
    latency = registry_network_latencies.get_by_name(params.network_latency_name)
    cols = build_node_columns(nodes, getattr(latency, "city_index", None))
    proto = BatchedP2PHandel(params, adj, just_relay, device=dev)
    proto.SCORE_CACHE = bool(score_cache)
    net = BatchedNetwork(proto, latency, proto.n_nodes, capacity=capacity, device=dev)
    state = net.init_state(cols, seed=seed, proto=proto.proto_init(proto.n_nodes, device=dev))
    return net, state
