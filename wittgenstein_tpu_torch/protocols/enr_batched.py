"""Batched ENRGossiping: node-record gossip with churn, ported to PyTorch.

A line-for-line port of the JAX package's protocols/enr_batched.py — its
module docstring gives the model: M preallocated slots with an `alive`
mask and a host-sampled birth, exit, broadcast and capability-change
calendar sent as size-0 WAKE self-messages with explicit arrivals; a
dense `[M, M]` bool adjacency edited by births, exits and `on_flood`'s
connect and swap; scores in closed form over matching-capability
neighbour counts; isFullyConnected as a per-capability transitive
closure; schedules that fire when the step's window (last_t, t] crosses
them, so TIME_QUANTUM = 8 never steps over an event.  What changes here
is representation and what is computed, never the result:

  * every tensor carries the replica axis R in front ([R, M, ...]); the
    clock `t` is the engine's host int, `last_t` an [R] leaf;
  * `deliver` compacts the delivered rows of the view, and of the
    announcing nodes, first (one device read, `ops.indexing.live_rows`),
    keeping view order, so the dedup winner per (receiver, source) and
    the one peer evaluation per receiver are the same lowest-slot races
    (`first_in_cell`);
  * the record forwards carry the winners' rows only, in view order
    (one more device read), instead of the JAX package's `[K * M]` rows
    over the whole view; the send path hashes no row position, and the
    spacing rank is taken over each source row's own destinations, as in
    JAX.  Without a winner the emission goes out with no rows and keeps
    its send counter;
  * the birth pick's `[M, M]` hash and stable sort run only for the
    replicas with a birth in their window, capability draws only when a
    replica changes, and a wake emission only when a replica re-arms its
    schedule (one device read for all three; a wake's rows take no send
    counter, so one with every row masked changes nothing);
  * `on_flood` runs only when a replica has a record to evaluate, and
    removeWorseIfPossible's `[M, M, C]` scan on the (replica, node)
    rows that evaluate a peer while at max_peers only — everywhere else
    its result is unused;
  * `_fully_connected` runs only for the replicas with a node whose done
    mark can still change (touched, alive and not done yet): the done
    check reads it nowhere else;
  * the products `_kc`, the closure and `starts @ reach` multiply 0/1
    matrices.  PyTorch has no CUDA integer matmul, so they run in
    float32 on both devices: every sum is at most M and exact far below
    2^24 (also under TF32, whose products of 0/1 are exact and whose
    sums accumulate in float32).

ENR runs on the flat store (`wheel_rows=0`): its calendar schedules
arrivals hours ahead.  So its loop reads no wheel occupancy and launches
no hand-written kernel, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.node import Node, build_node_columns
from ..core.registries import registry_network_latencies, registry_node_builders
from ..engine.core import BatchedNetwork, Emission, resolve_device
from ..engine.protocol import BatchedProtocol
from ..engine.rng import hash32
from ..ops.indexing import first_in_cell, live_rows, put_cells, take
from .enr_gossiping import PEERS_PER_CAP, ENRParameters, enr_population

INT32_MAX = 2**31 - 1
# removeWorseIfPossible's score of a slot that is no peer
NO_PEER = -(2**30)


def birth_order(rank: torch.Tensor, k: int) -> torch.Tensor:
    """The first k columns of a stable argsort of rank [..., M] (jnp.argsort
    is stable): ties keep the lower slot first."""
    return torch.sort(rank, dim=-1, stable=True).indices[..., :k]


def swap_pick(s_swap: torch.Tensor) -> torch.Tensor:
    """argmax over the last axis, the first maximal index on ties, as
    jnp.argmax gives (torch.argmax documents the same on both devices)."""
    return torch.argmax(s_swap, dim=-1)


class BatchedENR(BatchedProtocol):
    MSG_TYPES = ["RECORD", "WAKE"]
    PAYLOAD_WIDTH = 2  # (source, seq)
    TICK_INTERVAL = None  # event-driven: wakes carry the schedule
    # arrivals on an 8 ms grid, as in the JAX package (enr_batched.py:67-72)
    TIME_QUANTUM = 8

    def __init__(self, params: ENRParameters, m_slots: int, schedule: dict, device=None):
        self.params = params
        self.m = m_slots
        self.n_caps = params.number_of_different_capabilities
        self.schedule = schedule  # host-side columns, see make_enr
        self.device = resolve_device(device)
        self.ids = torch.arange(m_slots, dtype=torch.int32, device=self.device)
        self.eye = torch.eye(m_slots, dtype=torch.bool, device=self.device)

    def msg_size(self, mtype: int) -> int:
        return [1, 0][mtype]  # Record size 1; wakes are task-style

    # -- capability scoring (closed form) ------------------------------------
    @staticmethod
    def _kc(adj, caps, own):
        """k_c[i, c] = matching-cap neighbour counts: adjacent holders of c,
        counted only for c in i's own set (a float32 product of 0/1
        operands: exact, see the module docstring)."""
        k = torch.matmul(adj.to(torch.float32), caps.to(torch.float32)).to(torch.int32)
        return k * own.to(torch.int32)

    @staticmethod
    def _score_from_counts(k):
        """score_of: each cap contributes k_c * min(k_c, PEERS_PER_CAP)."""
        return (k * k.clamp(max=PEERS_PER_CAP)).sum(-1, dtype=torch.int32)

    def _gen_caps(self, seed, t: int):
        """cap_per_node distinct capabilities per node [R, M, C]: top-k of
        hashed per-cap scores (signed int32 order, ties all kept)."""
        c = self.n_caps
        caps = torch.arange(c, dtype=torch.int32, device=self.device)
        scores = hash32(seed[:, None, None], self.ids[None, :, None], caps[None, None, :], t)
        kth = torch.sort(scores, dim=-1).values[..., c - self.params.cap_per_node]
        return scores >= kth[..., None]

    # -- flood forwarding ----------------------------------------------------
    def _forward(self, adj, alive, src, rec_src, seq, mask, exclude, t: int):
        """Rows src [R, K] forward record (rec_src, seq) to all their live
        peers except `exclude`, with Record(local_delay=10,
        delay_between_peers=10) spacing: the k-th sent destination leaves
        at t + 1 + 10 + 11 k."""
        r, k = src.shape
        m = self.m
        rows = torch.gather(adj, 1, src.to(torch.int64)[..., None].expand(r, k, m))
        ok = (mask[..., None] & rows & (self.ids != exclude[..., None])
              & alive[:, None, :])  # [R, K, M]
        rank = ok.to(torch.int32).cumsum(-1) - 1

        def rep(a):
            return a.repeat_interleave(m, dim=1)

        return Emission(
            mask=ok.reshape(r, k * m),
            from_idx=rep(src),
            to_idx=self.ids.repeat(k),
            mtype=self.mtype("RECORD"),
            payload=torch.stack([rep(rec_src), rep(seq)], -1),
            send_time=(t + 1 + 10 + rank * 11).reshape(r, k * m),
        )

    def _forward_live(self, adj, alive, compact, cols, t: int, r: int):
        """The forward emission of the compacted rows `compact` (a live_rows
        entry) of the [R, K] columns (src, rec_src, seq, exclude); no rows
        when no replica has one."""
        if compact is None:
            return Emission.no_rows(r, self.mtype("RECORD"), self.PAYLOAD_WIDTH, self.device)
        idx, live = compact
        src, rec_src, seq, exclude = (torch.gather(c, 1, idx) for c in cols)
        return self._forward(adj, alive, src, rec_src, seq, live, exclude, t)

    def _wake(self, mask, arrival):
        return Emission(mask=mask, from_idx=self.ids, to_idx=self.ids,
                        mtype=self.mtype("WAKE"), arrival=arrival)

    # -- state ---------------------------------------------------------------
    def proto_init(self, n_nodes: int):
        s = self.schedule
        dev = self.device

        def t(a):
            return torch.as_tensor(np.asarray(a), device=dev)

        return {
            "alive": t(s["alive0"]),
            "caps": t(s["caps0"]),
            "adj": t(s["adj0"]),
            "seen": torch.full((self.m, self.m), -1, dtype=torch.int32, device=dev),
            "records": torch.zeros(self.m, dtype=torch.int32, device=dev),
            "start_time": torch.zeros(self.m, dtype=torch.int32, device=dev),
            "born_at": t(s["born_at"]),
            "exit_at": t(s["exit_at"]),
            "bcast_next": t(s["bcast0"]),
            "change_next": t(s["change0"]),
            # time of the previous step: schedules fire on window crossing
            "last_t": torch.tensor(-1, dtype=torch.int32, device=dev),
        }

    def initial_emissions(self, net, state):
        proto = state.proto
        return [
            self._wake(guard, proto[col])
            for col, guard in (
                ("born_at", proto["born_at"] > 0),
                ("exit_at", proto["exit_at"] < INT32_MAX),
                ("bcast_next", proto["bcast_next"] < INT32_MAX),
                ("change_next", proto["change_next"] < INT32_MAX),
            )
        ]

    # -- the event handler ---------------------------------------------------
    def _births(self, seed, alive, born, t: int, reps: torch.Tensor):
        """The newborns' links [R, M, M] (row_new | row_new.T): each newborn
        of the replicas `reps` takes total_peers hash-ranked alive slots;
        ineligible slots and a masked hash of INT32_MAX rank INT32_MAX and
        are never taken."""
        m, tp = self.m, self.params.total_peers
        ids = self.ids
        links = torch.zeros((alive.shape[0], m, m), dtype=torch.bool, device=self.device)
        if reps.numel() == 0:
            return links
        a, b = alive[reps], born[reps]
        rank = hash32(seed[reps, None, None], t, ids[None, :, None], ids[None, None, :])
        eligible = a[:, None, :] & (ids[None, :] != ids[:, None])
        rank = torch.where(eligible, rank & 0x7FFFFFFF, INT32_MAX)
        order = birth_order(rank, tp)  # [Rb, M, tp]
        sel = (torch.gather(rank, 2, order) != INT32_MAX) & b[..., None]
        row_new = torch.zeros_like(eligible).scatter_(2, order, sel)
        # scatter_ writes `sel` at `order`: taken slots are distinct per row
        links[reps] = row_new | row_new.transpose(1, 2)
        return links

    def deliver(self, net, state, deliver_mask, t: int):
        p = self.params
        proto = state.proto
        r = deliver_mask.shape[0]
        m = self.m
        ids = self.ids
        alive, caps, adj = proto["alive"], proto["caps"], proto["adj"]
        last_t = proto["last_t"][:, None]

        def crossed(sched):
            return (sched > last_t) & (sched <= t)

        # ---- births, exits, capability changes, gossip beats
        born = ~alive & crossed(proto["born_at"]) & (proto["born_at"] > 0)
        exit_due = crossed(proto["exit_at"])
        change_due = crossed(proto["change_next"])
        bcast_due = crossed(proto["bcast_next"])
        # which replicas have a birth, and whether any replica has a
        # capability change or a beat due (one device read): a schedule no
        # replica crosses is skipped, and so is its wake emission, whose
        # rows would all be masked (explicit arrivals take no send counter)
        flags = torch.cat([born.any(-1), torch.stack([change_due.any(),
                                                      bcast_due.any()])]).tolist()
        any_change, any_bcast = flags[r:]
        reps = torch.tensor([i for i in range(r) if flags[i]], dtype=torch.int64,
                            device=self.device)
        adj = adj | self._births(state.seed, alive, born, t, reps)
        alive = alive | born
        start_time = torch.where(born, t, proto["start_time"])
        touched = born

        keep = ~(alive & exit_due)
        adj = adj & keep[:, :, None] & keep[:, None, :]
        alive = alive & keep

        emissions = []
        seq_out, records, seen = proto["records"], proto["records"], proto["seen"]
        change_next, bcast_next = proto["change_next"], proto["bcast_next"]
        announce = torch.zeros_like(alive)
        if any_change:
            changing = alive & change_due
            caps = torch.where(changing[..., None], self._gen_caps(state.seed, t), caps)
            change_next = torch.where(changing, change_next + p.time_to_change, change_next)
            emissions.append(self._wake(changing, change_next))
            announce = changing  # change_cap also floods a fresh record
        if any_bcast:
            bcast = alive & bcast_due
            bcast_next = torch.where(bcast, bcast_next + p.cap_gossip_time, bcast_next)
            emissions.append(self._wake(bcast, bcast_next))
            announce = announce | bcast
        if any_change or any_bcast:
            records = seq_out + announce.to(torch.int32)
            # originators never reprocess their own record
            seen = put_cells(seen, ids * (m + 1), seq_out, announce, reduce="amax")

        # the announcing nodes and the delivered rows, compacted together
        ann_rows, drows = live_rows([announce, deliver_mask])
        if drows is None:
            drows = (torch.zeros((r, 0), dtype=torch.int64, device=self.device),
                     torch.zeros((r, 0), dtype=torch.bool, device=self.device))
        didx, dlive = drows
        ids_r = ids.expand(r, m)
        emissions.append(self._forward_live(
            adj, alive, ann_rows, (ids_r, ids_r, seq_out, torch.full_like(ids_r, -1)), t, r))

        # ---- record deliveries: dedup, forward, evaluate source as peer
        def col(c):
            return torch.gather(c, 1, didx)

        to, frm = col(state.msg_to), col(state.msg_from)
        src, seq = col(state.msg_payload[..., 0]), col(state.msg_payload[..., 1])
        is_rec = dlive & (col(state.msg_type) == self.mtype("RECORD"))
        cell = to.to(torch.int64) * m + src
        fresh = is_rec & take(alive, to) & (seq > take(seen.reshape(r, -1), cell))
        # highest seq per (to, src) wins the dedup table
        seen = put_cells(seen, cell, seq, fresh, reduce="amax")
        win = fresh & (take(seen.reshape(r, -1), cell) == seq)
        # the lowest winning row per (to, src) forwards
        fwd = first_in_cell(cell, win, m * m)
        (fwd_rows,) = live_rows([fwd])
        emissions.append(self._forward_live(adj, alive, fwd_rows, (to, src, seq, frm), t, r))

        # one peer evaluation per receiver: its lowest forwarding row (none
        # in any replica without a forwarding row)
        if fwd_rows is not None:
            ev = first_in_cell(to, fwd, m)
            eval_src = put_cells(torch.full((r, m), -1, dtype=torch.int32, device=self.device),
                                 to, src, ev)
            adj, connect, s_idx = self._on_flood(adj, caps, alive, eval_src)
            touched = touched | connect
            touched = touched | put_cells(torch.zeros_like(connect), s_idx, True, connect)

        # ---- done checks for touched nodes (isFullyConnected)
        cand = touched & alive & (state.done_at == 0)
        done_now = cand & self._fully_connected_where(alive, caps, adj, cand.any(-1))
        rel = torch.clamp(t - start_time, min=1)
        state = state._replace(
            done_at=torch.where(done_now, rel, state.done_at),
            proto=dict(proto, alive=alive, caps=caps, adj=adj, seen=seen, records=records,
                       start_time=start_time, change_next=change_next,
                       bcast_next=bcast_next, last_t=torch.full_like(proto["last_t"], t)),
        )
        return state, emissions

    def _on_flood(self, adj, caps, alive, eval_src):
        """on_flood (ENRGossiping.java:296-322) for every receiver with a
        source to evaluate: canConnect, addedValue, removeWorseIfPossible.
        Removals apply before additions.  Returns (adj, connect, s_idx)."""
        p = self.params
        r, m = eval_src.shape
        ids = self.ids
        has_eval = eval_src >= 0
        s_idx = eval_src.clamp(min=0)
        deg = adj.sum(-1, dtype=torch.int32)
        k0 = self._kc(adj, caps, caps)  # [R, M, C]
        s0 = self._score_from_counts(k0)  # current score_of(peers)
        cap_s = torch.gather(caps, 1, s_idx.to(torch.int64)[..., None].expand_as(caps))
        match_s = (cap_s & caps).to(torch.int32)
        added_value = self._score_from_counts(k0 + match_s) - s0
        linked = take(adj.reshape(r, -1), ids.to(torch.int64) * m + s_idx)
        can = (has_eval & alive & take(alive, s_idx) & (take(deg, s_idx) < p.max_peers)
               & ~linked & (added_value != 0))
        at_cap = deg >= p.max_peers

        # removeWorseIfPossible (:417-438): best single-peer swap, on the
        # rows that need it
        j_best = torch.zeros((r, m), dtype=torch.int64, device=self.device)
        swap_ok = torch.zeros_like(can)
        rows = torch.nonzero((can & at_cap).reshape(-1)).flatten()
        if rows.numel():
            ri, ii = rows // m, rows % m
            jb, ok = self._remove_worst(adj[ri, ii], caps[ri], caps[ri, ii], k0[ri, ii],
                                        s0[ri, ii], match_s[ri, ii])
            j_best = j_best.reshape(-1).index_copy(0, rows, jb).reshape(r, m)
            swap_ok = swap_ok.reshape(-1).index_copy(0, rows, ok).reshape(r, m)
        connect = can & (~at_cap | swap_ok)
        drop_j = can & at_cap & swap_ok

        # removals first, then additions (same-ms race policy)
        i64 = ids.to(torch.int64)
        s64 = s_idx.to(torch.int64)
        flat = adj.reshape(r, -1)
        flat = put_cells(flat, i64 * m + j_best, False, drop_j)
        flat = put_cells(flat, j_best * m + i64, False, drop_j)
        flat = put_cells(flat, i64 * m + s64, True, connect)
        flat = put_cells(flat, s64 * m + i64, True, connect)
        return flat.reshape(r, m, m), connect, s_idx

    def _remove_worst(self, adj_i, caps_r, caps_i, k0_i, s0_i, match_s_i):
        """The swap scan of P receiver rows: for each peer j, the score with
        j replaced by the source; the first best j, and whether it beats
        the current score.  adj_i [P, M], caps_r [P, M, C] (the row's
        replica's caps), the rest [P, C] / [P]."""
        match_j = (caps_r & caps_i[:, None, :]).to(torch.int32)  # [P, j, C]
        k_swap = k0_i[:, None, :] - match_j + match_s_i[:, None, :]
        s_swap = torch.where(adj_i, self._score_from_counts(k_swap), NO_PEER)
        j_best = swap_pick(s_swap)
        s_best = torch.gather(s_swap, 1, j_best[:, None])[:, 0]
        return j_best, s_best > s0_i

    def _fully_connected_where(self, alive, caps, adj, need: torch.Tensor):
        """`_fully_connected` [R, M] on the replicas where `need` [R] holds
        (one device read), False elsewhere."""
        out = torch.zeros_like(alive)
        reps = torch.nonzero(need).flatten()
        if reps.numel():
            out[reps] = self._fully_connected(alive[reps], caps[reps], adj[reps])
        return out

    def _fully_connected(self, alive, caps, adj):
        """score >= 3*|caps| and every own capability's subgraph reaches at
        least half that capability's alive holders (BFS -> closure by
        squaring the cap-confined adjacency)."""
        m = self.m
        k = self._kc(adj, caps, caps)
        score_ok = self._score_from_counts(k) >= self.params.cap_per_node * PEERS_PER_CAP
        holders = caps & alive[..., None]  # [R, M, C]
        h_t = holders.transpose(1, 2)  # [R, C, M]
        a_c = adj[:, None] & h_t[..., :, None] & h_t[..., None, :]  # [R, C, M, M]
        reach = (a_c | self.eye).to(torch.float32)
        for _ in range(max(1, int(np.ceil(np.log2(max(2, m)))))):
            reach = (reach + reach @ reach).clamp(max=1)
        starts = (adj[:, None] & h_t[..., None, :]).to(torch.float32)
        explored = ((starts @ reach) > 0) | self.eye  # [R, C, i, k]: self counts
        count = explored.sum(-1, dtype=torch.int32).transpose(1, 2)  # [R, M, C]
        threshold = holders.sum(1, dtype=torch.int32)[:, None, :] // 2
        ok_c = torch.where(caps, count >= threshold, True)
        return score_ok & ok_c.all(-1)

    def all_done(self, state):
        return torch.where(state.proto["alive"], state.done_at > 0, True).all(-1)


def make_enr(
    params: Optional[ENRParameters] = None,
    horizon_ms: int = 4_000_000,
    capacity: int = 1 << 12,
    seed: int = 0,
    device=None,  # None = CUDA; "cpu" runs the plain versions
):
    """Host-side construction: the replay of the oracle's init() for the
    initial population, then the join, exit and beat schedule from the
    continuing generator, in the JAX package's order (enr_batched.py
    :394-469), baked into the engine on the flat store; returns (net,
    single-replica state).

    `horizon_ms` bounds the join schedule: one slot per time_to_leave / 8
    beat up to the horizon; running past it stops producing joiners."""
    dev = resolve_device(device)
    params = params or ENRParameters()
    onet, changed = enr_population(params)
    rd = onet.rd

    n0 = params.nodes
    period = params.time_to_leave // 8
    n_join = min(horizon_ms // period + 1, 4096)
    m = n0 + int(n_join)

    caps0 = np.zeros((m, params.number_of_different_capabilities), bool)
    adj0 = np.zeros((m, m), bool)
    alive0 = np.zeros(m, bool)
    for i, nd in enumerate(onet.all_nodes):
        alive0[i] = True
        caps0[i, list(nd.capabilities)] = True
        for pr in nd.peers:
            adj0[i, pr.node_id] = True
    born_at = np.zeros(m, np.int32)
    exit_at = np.full(m, INT32_MAX, np.int32)
    bcast0 = np.full(m, INT32_MAX, np.int32)
    change0 = np.full(m, INT32_MAX, np.int32)
    for j in range(n_join):
        i = n0 + j
        born_at[i] = j * period
        caps_set = set()
        while len(caps_set) < params.cap_per_node:
            caps_set.add(rd.next_int(params.number_of_different_capabilities))
        caps0[i, list(caps_set)] = True
        if j == 0:
            # the oracle's first joiner arrives at t=0, inside init: wired
            # here (the birth mask only fires for t > 0)
            alive0[i] = True
            wired = 0
            while wired < params.total_peers:
                tgt = rd.next_int(n0 + 1)
                if tgt != i and alive0[tgt] and not adj0[i, tgt]:
                    adj0[i, tgt] = adj0[tgt, i] = True
                    wired += 1
        if born_at[i] > 1:
            exit_at[i] = int(born_at[i]) + rd.next_int(params.time_to_leave)
        b = int(born_at[i]) + rd.next_int(params.cap_gossip_time) + 1
        if b < exit_at[i]:
            bcast0[i] = b
    # initial nodes: broadcast beats (start() for t=0 nodes: no exit)
    for i in range(n0):
        bcast0[i] = rd.next_int(params.cap_gossip_time) + 1
    # the capability-change calendar: fresh draws from the continuing stream
    for nid in changed:
        change0[nid] = rd.next_int(params.time_to_change) + 1

    schedule = {"alive0": alive0, "caps0": caps0, "adj0": adj0, "born_at": born_at,
                "exit_at": exit_at, "bcast0": bcast0, "change0": change0}
    proto = BatchedENR(params, m, schedule, device=dev)

    latency = registry_network_latencies.get_by_name(params.network_latency_name)
    # node columns: the oracle's nodes, then the joiners drawn with the
    # same builder from the continuing stream
    nodes = list(onet.all_nodes)
    nb = registry_node_builders.get_by_name(params.node_builder_name)
    while len(nodes) < m:
        nodes.append(Node(rd, nb))
    cols = build_node_columns(nodes, getattr(latency, "city_index", None))
    net = BatchedNetwork(proto, latency, m, capacity=capacity, wheel_rows=0, device=dev)
    state = net.init_state(cols, seed=seed, proto=proto.proto_init(m))

    # t=0 fully-connected marks (start() -> set_done_at at birth)
    p1 = {k: v[None] for k, v in state.proto.items()}
    done0 = proto._fully_connected(p1["alive"], p1["caps"], p1["adj"])[0] & p1["alive"][0]
    return net, state._replace(done_at=torch.where(done0, 1, state.done_at))
