"""Batched ETHPoW: Bernoulli mining over a preallocated block table, with
the replica axis R carried in front of every tensor.

Port of the JAX package's protocols/ethpow_batched.py (the re-expression
of ETHPoW.java + ETHMiner.java): a block table per replica (parent,
height, producer, proposal time, difficulty, total difficulty relative to
genesis) with a dense arrival matrix `arrival [R, B, M]`; one Bernoulli
trial per miner per 10 ms beat with success probability
1 - exp(-hashes_per_10ms / difficulty); fork choice by total difficulty
with the own block first on ties, else the lowest index; Constantinople
difficulty from the mainnet genesis; and the pos-1 strategies of
BATCHED_BYZ: the two selfish miners (ETHSelfishMiner, ETHSelfishMiner2)
and the RL agent (ETHMinerAgent, driven by ethpow_env.BatchedMinerEnv).
ETHPoW keeps its own state type and loop: it does not use BatchedNetwork.

Three forms differ from the JAX package's, with the same results:

  * The loop.  JAX runs one `_beat` per 10 ms in a `lax.while_loop`.  A
    beat changes only the clock unless a block arrives somewhere
    (`arrival` in (t-10, t]), a trial succeeds, a miner is not mining (the
    beat after a success, or the first beat), or an action was applied —
    otherwise fork choice, the receive phases and the restart find what
    they found the beat before.  So `run_ms` is an event loop with a clock
    per replica: each iteration moves every replica to its own next event
    beat — the first beat of its grid at or after its next arrival, or the
    first of a chunk of CHUNK_BEATS beats whose trial hash falls under
    its thresholds (constant between restarts) — and runs one full `_beat`
    there with `t` an [R] tensor; a replica with no event in the chunk
    jumps to the chunk's end.  The first beat of every call runs in full.
    `run_ms_beats` is the per-beat loop, the JAX form, kept as the
    reference the event loop is tested against.
  * The scalar walks of the receive phases (`lax.while_loop`s per
    replica): a pointer walk whose condition reads only the block runs by
    pointer doubling over the whole table (`_walk`, no device read); a
    release loop is a masked loop over the replicas still sending, one
    device read every RELEASE_TRIPS trips, whose rows are drawn together
    after it.  The loop's other device read is whether any replica is
    still running: the port keeps the device reads per iteration to one
    or two, since each one stalls the host until the card has caught up.
  * The threshold's `exp`.  A one-ulp step of `exp` near 1 moves the
    threshold by 2^-24, the trial's grain, so a trial flips when its
    draw falls on that step: the threshold must be XLA's float32 `exp`
    bit for bit, which neither torch's float32 `exp` nor a rounded
    float64 `exp` is.  `exp_f32` is XLA's CPU sequence itself (a
    Cody-Waite range reduction, a degree-6 polynomial whose steps are
    fused multiply-adds, then 1 + p and a scale by 2^n), each fused step
    taken as one float64 multiply-add rounded to float32: a product of
    two float32 is exact in float64, so each step rounds the exact
    a*b + c once to float64 and once to float32.  Every operation is a
    correctly rounded IEEE float64 or float32 operation, so the result
    is the same on the CPU and on the card.  Covered range: every
    float32 x with -x in [2^-20, 2^-6) (EXP_COVERED), where
    scripts/torch_ethpow_exp_check.py enumerates every argument and
    finds no difference from XLA's; the thresholds' arguments
    -hp_per_10ms / cand_diff lie in about [2^-14, 2^-11) at the genesis
    difficulty for the hash powers of 10 miners (a 45% miner's 2^-10.9,
    the others' 2^-13.8 beside it, 2^-13.1 when all are equal), which
    leaves five binades and more of margin on each side for the
    difficulty's drift.  Outside the range
    the port promises no equality (the same script finds none from
    -x = 2^-40 to 2^6).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.latency import LatencyStatic, vec_latency
from ..core.node import Node, build_node_columns
from ..core.registries import registry_network_latencies, registry_node_builders
from ..engine.core import resolve_device
from ..engine.rng import HASH32_START, hash32, hash32_absorb, pseudo_delta, to_i32, u01
from ..utils.javarand import JavaRandom
from .ethpow import ETHPoWParameters

INT32_MAX = 2**31 - 1
GENESIS_DIFFICULTY = 1_949_482_043_446_410.0
GENESIS_HEIGHT = 7_951_081  # mainnet block (ETHPoW.java:158-164)
TOTAL_HASH_POWER_GHS = 200 * 1024  # ETHPoW.java:72
BEAT_MS = 10
SELFISH_ID = 1  # the bad node is always at pos 1 (ETHPoW.java:78-87)
# beats a trial search looks ahead per event-loop iteration
CHUNK_BEATS = 128
# release-loop trips between two device reads of whether any replica sends
RELEASE_TRIPS = 4

# byz_class_name -> batched strategy id (pos-1 miner, ETHPoW.java:78-87)
BATCHED_BYZ = {
    "ETHMiner": 0,
    "ETHSelfishMiner": 1,
    "ETHSelfishMiner2": 2,
    "ETHMinerAgent": 3,
}


class EthPowState(NamedTuple):
    """Simulation state, the JAX package's EthPowState leaf for leaf; a
    batched state carries [R] in front of every leaf."""

    time: torch.Tensor  # int32
    seed: torch.Tensor  # int32
    # block table
    n_blocks: torch.Tensor  # int32 (slot 0 = genesis)
    parent: torch.Tensor  # int32[B]
    height: torch.Tensor  # int32[B]
    producer: torch.Tensor  # int32[B], -1 = genesis
    b_time: torch.Tensor  # int32[B] proposal time (mining start)
    diff: torch.Tensor  # float32[B]
    td: torch.Tensor  # float32[B], relative to genesis
    arrival: torch.Tensor  # int32[B, M]
    overflowed: torch.Tensor  # int32: blocks lost to a full table
    # per-miner state
    head: torch.Tensor  # int32[M]
    father: torch.Tensor  # int32[M] (mining candidate's parent)
    cand_time: torch.Tensor  # int32[M]
    cand_diff: torch.Tensor  # float32[M]
    mining: torch.Tensor  # bool[M]
    blocks_mined: torch.Tensor  # int32[M]
    # selfish-miner columns (inert without a byz strategy)
    pmb: torch.Tensor  # int32: private_miner_block idx, -1 = None
    omh: torch.Tensor  # int32: other_miners_head idx
    withheld: torch.Tensor  # bool[B]: mined_to_send set


# XLA's CPU float32 exp (its Cephes-derived polynomial), constants as the
# float32 values it rounds them to
def _f32(v: float) -> float:
    return float(np.float32(v))


_EXP_CLAMP = _f32(88.8)
_LOG2E = _f32(1.44269504088896341)
_LN2_HI, _LN2_LO = _f32(0.693359375), _f32(-2.12194440e-4)
_EXP_POLY = tuple(_f32(c) for c in (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
                                     4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1))
# -x over which exp_f32 is enumerated equal to XLA's, [lo, hi)
EXP_COVERED = (2.0**-20, 2.0**-6)


def _round32(x: torch.Tensor) -> torch.Tensor:
    """A float64 tensor rounded to float32, kept in float64."""
    return x.to(torch.float32).to(torch.float64)


def _fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 fused multiply-add of float32 values held in float64: a*b is
    exact in float64, + c rounds once there, then once to float32."""
    return _round32(a * b + c)


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 `exp` of a float32 tensor, bit for bit over
    EXP_COVERED (see the module docstring): n = floor(x log2e + 1/2),
    a = x - n ln2 in two fused steps, z = 1 + a + a^2 p(a) with p's
    Horner steps fused, times 2^n built from its exponent bits (0 for
    n = -127: XLA flushes results below 2^-126)."""
    x = x.to(torch.float64).clamp(-_EXP_CLAMP, _EXP_CLAMP)
    n = torch.floor(_fma32(x, _LOG2E, 0.5)).clamp(-127.0, 127.0)
    a = _fma32(-n, _LN2_LO, _fma32(-n, _LN2_HI, x))
    z = _fma32(a, _EXP_POLY[0], _EXP_POLY[1])
    for c in _EXP_POLY[2:]:
        z = _fma32(z, a, c)
    z = _round32(1.0 + _fma32(z, _round32(a * a), a))
    pow2 = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return z.to(torch.float32) * pow2


def _at(col: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """col[r, idx[r, ...]] for col [R, B] and idx [R] or [R, K]."""
    if idx.dim() == 1:
        return col.gather(1, idx[:, None].to(torch.int64))[:, 0]
    return col.gather(1, idx.to(torch.int64))


def _put(col: torch.Tensor, slot: torch.Tensor, vals) -> torch.Tensor:
    """Functional drop-mode `col.at[slot].set(vals)` per replica: col [R, B,
    ...], slot [R, K] with B = dropped (a trash row past the end)."""
    r, b = col.shape[:2]
    rest = tuple(col.shape[2:])
    ext = torch.cat([col, col.new_zeros((r, 1) + rest)], 1)
    if not isinstance(vals, torch.Tensor):
        vals = torch.full(slot.shape + rest, vals, dtype=col.dtype, device=col.device)
    idx = slot.to(torch.int64).view(slot.shape + (1,) * len(rest)).expand(slot.shape + rest)
    return ext.scatter(1, idx, vals.to(col.dtype))[:, :b]


def _floor_div(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _walk(par: torch.Tensor, i: torch.Tensor, walks: torch.Tensor) -> torch.Tensor:
    """`lax.while_loop(cond, lambda i: par[i], i)` for every replica, for a
    cond that reads only the block: walks [R, B] is cond at every block.
    Pointer doubling: a block where the walk stops points at itself, and
    ceil(log2 B) squarings of the pointers reach every walk's stop (a
    chain has fewer than B blocks).  No device read."""
    b = par.shape[1]
    ids = torch.arange(b, dtype=par.dtype, device=par.device)
    jump = torch.where(walks, par, ids).to(torch.int64)
    for _ in range(max(1, math.ceil(math.log2(b)))):
        jump = jump.gather(1, jump)
    return jump.gather(1, i.to(torch.int64)[:, None])[:, 0].to(torch.int32)


class BatchedEthPow:
    """The simulation: binds the miner population and latency model to the
    beat over EthPowState.  One instance serves any replica count."""

    def __init__(
        self,
        params: Optional[ETHPoWParameters] = None,
        b_max: int = 512,
        seed: int = 0,
        device=None,  # None = CUDA; "cpu" runs on the CPU
    ):
        params = params or ETHPoWParameters()
        if params.byz_class_name:
            key = params.byz_class_name.rsplit(".", 1)[-1]
            if key not in BATCHED_BYZ:
                raise NotImplementedError(
                    f"batched ETHPoW supports {sorted(BATCHED_BYZ)} as byz_class_name; the "
                    "CSV decision logger (ETHAgentMiner) runs on the JAX package's oracle"
                )
            self.variant = BATCHED_BYZ[key]
        else:
            self.variant = None
        self.device = resolve_device(device)
        self.selfish = self.variant in (1, 2)
        self.agent = self.variant == 3
        self.params = params
        self.b_max = b_max
        self.m = params.number_of_miners
        nb = registry_node_builders.get_by_name(params.node_builder_name)
        self.latency = registry_network_latencies.get_by_name(params.network_latency_name)
        rd = JavaRandom(seed)
        nodes = [Node(rd, nb) for _ in range(self.m)]
        self.cols = build_node_columns(nodes, getattr(self.latency, "city_index", None))

        def col(name):
            return torch.as_tensor(self.cols[name], dtype=torch.int32, device=self.device)[None]

        self._static_cols = (col("x"), col("y"), col("extra_latency"), col("city_idx"))
        # hash-power split (ETHPoW.java:70-87): miner 1 takes the byz share,
        # honest miners split the remainder evenly
        total = TOTAL_HASH_POWER_GHS
        byz_hp = int(total * params.byz_mining_ratio) if self.variant is not None else 0
        honest_n = self.m if byz_hp == 0 else self.m - 1
        honest_hp = (total - byz_hp) // honest_n
        hp = np.full(self.m, honest_hp, np.float64)
        if self.variant is not None:
            hp[SELFISH_ID] = byz_hp
        self.hp_per_10ms = torch.as_tensor(
            (hp * (1024.0**3) / 100.0).astype(np.float32), device=self.device)
        self.mids = torch.arange(self.m, dtype=torch.int32, device=self.device)
        self._bids = torch.arange(b_max, dtype=torch.int32, device=self.device)
        self.jump_stats = None  # set by each run_ms

    def _static(self, r: int) -> LatencyStatic:
        """The miners' latency columns, shared by every replica, as [R, M]."""
        return LatencyStatic(*[c.expand(r, self.m) for c in self._static_cols])

    # -- state ---------------------------------------------------------------
    def init_state(self, seed: int = 0) -> EthPowState:
        b, m, dev = self.b_max, self.m, self.device

        def full(shape, v, dtype=torch.int32):
            return torch.full(shape, v, dtype=dtype, device=dev)

        arrival = full((b, m), INT32_MAX)
        arrival[0] = 0  # genesis known to everyone at t=0
        return EthPowState(
            time=full((), 1), seed=full((), seed), n_blocks=full((), 1),
            parent=full((b,), 0), height=full((b,), GENESIS_HEIGHT), producer=full((b,), -1),
            b_time=full((b,), 0), diff=full((b,), GENESIS_DIFFICULTY, torch.float32),
            td=full((b,), 0.0, torch.float32), arrival=arrival, overflowed=full((), 0),
            head=full((m,), 0), father=full((m,), 0), cand_time=full((m,), 0),
            cand_diff=full((m,), GENESIS_DIFFICULTY, torch.float32),
            mining=full((m,), False, torch.bool), blocks_mined=full((m,), 0),
            pmb=full((), -1), omh=full((), 0), withheld=full((b,), False, torch.bool),
        )

    # -- difficulty (ETHPoW.java:284-296; low-height bomb quirk kept) --------
    @staticmethod
    def _calc_difficulty(f_diff, f_time, f_height, ts):
        gap = _floor_div(ts - f_time, 9000).to(torch.float32)
        ugap = torch.clamp(1.0 - gap, min=-99.0)  # y = 1: no uncles
        diff = (f_diff / 2048.0) * ugap
        periods = _floor_div(f_height - 4_999_999, 100_000)
        bomb = torch.where(periods > 1, torch.exp2((periods - 2).to(torch.float32)), diff)
        return f_diff + diff + bomb

    def thresholds(self, cand_diff: torch.Tensor) -> torch.Tensor:
        """P(success per 10 ms) per miner, float32: 1 - exp(-hp / diff) with
        XLA's float32 `exp` (`exp_f32`, see the module docstring)."""
        return 1.0 - exp_f32(-self.hp_per_10ms / cand_diff)

    # -- the receive phases (scalar walks per replica) -----------------------
    def _newly_received(self, s: EthPowState, t):
        """The best external block that reached the miner at pos 1 in this
        beat, and whether it beats other_miners_head (ETHPoW.best)."""
        sm = SELFISH_ID
        arr_sm = s.arrival[:, :, sm]
        tc = t[:, None]
        newly = (arr_sm > tc - BEAT_MS) & (arr_sm <= tc) & (s.producer != sm) & (s.producer >= 0)
        rcv = torch.where(newly, s.td, -1.0).argmax(1).to(torch.int32)
        act = newly.any(1) & (_at(s.td, rcv) > _at(s.td, s.omh))
        return rcv, act

    def _release_walk(self, s, h_t, t, omh, withheld, arrival, i, cond, tag, track_omh):
        """The release loop: send block i and its withheld own ancestors,
        one send event per block, destinations at t+1+latency (send_block
        -> send_all); with `track_omh` other_miners_head takes each sent
        block that beats it (best: own wins ties).  The walk collects the
        sent blocks, one masked trip per block; their rows are drawn
        together after it (each block's row depends on its own event hash
        only, and a walk visits a block once)."""
        sent, live = [], []
        while True:
            c = cond(i, withheld)
            # one device read every RELEASE_TRIPS trips: the trips past a
            # replica's end are masked no-ops
            if len(sent) % RELEASE_TRIPS == 0 and not bool(c.any()):
                break
            if track_omh:
                omh = torch.where(c & (_at(s.td, i) >= _at(s.td, omh)), i, omh)
            withheld = withheld.scatter(1, i.to(torch.int64)[:, None],
                                        (_at(withheld, i) & ~c)[:, None])
            sent.append(i)
            live.append(c)
            i = torch.where(c, _at(s.parent, i), i)
        if not sent:
            return omh, withheld, arrival
        sm = SELFISH_ID
        r, m, b = s.time.shape[0], self.m, self.b_max
        idx, live = torch.stack(sent, 1), torch.stack(live, 1)  # [R, T]
        k = idx.shape[1]
        ev = to_i32(hash32_absorb(h_t, idx, tag))  # hash32(seed, t, idx, tag)
        to_idx = self.mids.expand(r, k, m)
        lat = vec_latency(
            self.latency, self._static(r),
            torch.full((r, k * m), sm, dtype=torch.int32, device=self.device),
            to_idx.reshape(r, -1), pseudo_delta(to_idx, ev[:, :, None]).reshape(r, -1),
        ).reshape(r, k, m)
        old = arrival.gather(1, idx.to(torch.int64)[:, :, None].expand(r, k, m))
        rows = torch.where(self.mids == sm, old[:, :, sm:sm + 1], t[:, None, None] + 1 + lat)
        return omh, withheld, _put(arrival, torch.where(live, idx, b), rows)

    def _selfish_receive(self, s: EthPowState, h_t, t, new_head):
        """on_received_block of the miner at pos 1 for the best newly
        arrived external block (variant 1 = ETHSelfishMiner.java:56-115,
        variant 2 = ETHSelfishMiner2.java:55-81).  Returns (omh, withheld,
        arrival, lose)."""
        sm = SELFISH_ID
        par, hgt, td, prod = s.parent, s.height, s.td, s.producer
        rcv, act = self._newly_received(s, t)
        omh = torch.where(act, rcv, s.omh)
        ph = torch.where(s.pmb >= 0, _at(hgt, s.pmb.clamp(min=0)), 0)
        safe_pmb = s.pmb.clamp(min=0)
        h_rcv, td_rcv = _at(hgt, rcv), _at(td, rcv)
        if self.variant == 1:
            delta_p = ph - (h_rcv - 1)
            lose = act & (delta_p <= 0)
            rel = act & (delta_p > 0)
            far = rel & (delta_p > 2)
            # far ahead: walk down to the oldest withheld block still above
            # rcv's height (ETHSelfishMiner.java:96-103)
            ts = _walk(par, safe_pmb, far[:, None] & s.withheld.gather(1, par.to(torch.int64))
                       & (hgt > h_rcv[:, None]))
            # the ancestor at rcv's height must still beat rcv, else return
            need = far & (_at(hgt, ts) != h_rcv)
            f = _walk(par, ts, need[:, None] & (hgt != h_rcv[:, None]) & (self._bids != 0))
            cancel = need & (_at(td, f) < td_rcv)
            do_rel = rel & ~cancel
        else:
            lose = act & (new_head[:, SELFISH_ID] == rcv)
            rel = act & ~lose & (s.pmb >= 0)
            # toward the oldest own block whose parent still beats rcv on
            # total difficulty (ETHSelfishMiner2.java:66-71)
            ts = _walk(par, safe_pmb, rel[:, None] & (self._bids != 0) & (hgt >= h_rcv[:, None])
                       & (td.gather(1, par.to(torch.int64)) > td_rcv[:, None]))
            do_rel = rel
        # losing clears mined_to_send through send_all_mined, whose hook
        # drops the blocks for selfish miners (ETHMiner.java:165-171 quirk)
        withheld = torch.where(lose[:, None], False, s.withheld)
        omh, withheld, arrival = self._release_walk(
            s, h_t, t, omh, withheld, s.arrival, ts,
            lambda i, wh: do_rel & (i > 0) & (_at(prod, i) == sm) & _at(wh, i),
            0x5E1F, True)
        return omh, withheld, arrival, lose

    def _release_rows(self, s: EthPowState, t, rel_mask, tag):
        """Arrival rows for every block in rel_mask [R, B]: one send event
        per released block, destinations at t+1+latency; the producer's own
        entry is untouched (min keeps its earlier arrival)."""
        r, b, m = rel_mask.shape[0], self.b_max, self.m
        ev = hash32(s.seed[:, None], t[:, None], self._bids, tag)  # [R, B]
        to_idx = self.mids.expand(r, b, m)
        delta = pseudo_delta(to_idx, ev[:, :, None])
        lat = vec_latency(
            self.latency, self._static(r),
            torch.full((r, b * m), SELFISH_ID, dtype=torch.int32, device=self.device),
            to_idx.reshape(r, -1), delta.reshape(r, -1),
        ).reshape(r, b, m)
        rows = torch.minimum(s.arrival, t[:, None, None] + 1 + lat)
        return torch.where(rel_mask[:, :, None], rows, s.arrival)

    def _agent_receive(self, s: EthPowState, h_t, t):
        """on_received_block of the RL agent at pos 1
        (ETHMinerAgent.java:187-204): other_miners_head = best(omh, rcv);
        withheld blocks the public chain has overtaken (height <=
        height[omh]) release oldest-first."""
        par, hgt = s.parent, s.height
        rcv, act = self._newly_received(s, t)
        omh = torch.where(act, rcv, s.omh)
        h_omh = _at(hgt, omh)
        start = _walk(par, s.pmb.clamp(min=0), (self._bids > 0) & (hgt > h_omh[:, None]))
        _, withheld, arrival = self._release_walk(
            s, h_t, t, omh, s.withheld, s.arrival, start,
            lambda i, wh: (i > 0) & _at(wh, i), 0xA6E7, False)
        return omh, withheld, arrival

    def agent_apply_action(self, s: EthPowState, k) -> EthPowState:
        """send_mined_blocks(k) (ETHMinerAgent.java:68-88) per replica, k an
        int or [R]: release the k OLDEST withheld blocks; omh advances to
        the highest released block that overtakes it; an emptied private
        chain clears private_miner_block.  The candidate restamp fires only
        when k exceeded the available blocks by exactly one (Java's
        post-decrement loop, kept bit-exact)."""
        sm = SELFISH_ID
        r = s.time.shape[0]
        hgt = s.height
        kk = torch.as_tensor(k, dtype=torch.int32, device=self.device).expand(r).clamp(min=0)
        low = torch.where(s.withheld, hgt, INT32_MAX).amin(1)
        rel = s.withheld & (hgt < (low + kk)[:, None])
        arrival = s.arrival
        if bool(rel.any()):
            arrival = self._release_rows(s, s.time, rel, 0xAC70)
        withheld = s.withheld & ~rel
        top = torch.where(rel, hgt, -1).argmax(1).to(torch.int32)
        omh = torch.where(rel.any(1) & (_at(hgt, top) > _at(hgt, s.omh)), top, s.omh)
        avail = s.withheld.sum(1, dtype=torch.int32)
        restart = (kk == avail + 1) & s.mining[:, sm] & (s.pmb >= 0)
        head = s.head[:, sm]
        new_diff = self._calc_difficulty(_at(s.diff, head), _at(s.b_time, head),
                                         _at(s.height, head), s.time)

        def set_sm(col, v):
            out = col.clone()
            out[:, sm] = torch.where(restart, v, col[:, sm])
            return out

        return s._replace(
            arrival=arrival, withheld=withheld, omh=omh,
            pmb=torch.where(withheld.any(1), s.pmb, -1),
            father=set_sm(s.father, head), cand_time=set_sm(s.cand_time, s.time),
            cand_diff=set_sm(s.cand_diff, new_diff),
        )

    # -- one 10 ms beat at each replica's own clock ---------------------------
    def _beat(self, s: EthPowState, u: Optional[torch.Tensor] = None,
              h_seed: Optional[torch.Tensor] = None) -> EthPowState:
        """One beat at each replica's clock `s.time`; `u` [R, M] are the
        trial draws of this beat and `h_seed` [R, 1] the hash state after
        the seed, when the caller has them."""
        t = s.time  # [R]
        r, m, b = t.shape[0], self.m, self.b_max
        mids = self.mids
        tc = t[:, None]
        if h_seed is None:
            h_seed = hash32_absorb(HASH32_START, s.seed[:, None])
        h_t = hash32_absorb(h_seed, tc)  # every hash of this beat starts (seed, t)

        # 1. fork choice over arrived blocks: max total difficulty; exact
        # ties prefer the own block, else the lowest index
        arrived = s.arrival <= t[:, None, None]  # [R, B, M]
        td_m = torch.where(arrived, s.td[:, :, None], -math.inf)
        is_max = td_m == td_m.amax(1, keepdim=True)
        own_max = is_max & (s.producer[:, :, None] == mids)
        first_any = is_max.to(torch.int32).argmax(1)
        first_own = own_max.to(torch.int32).argmax(1)
        new_head = torch.where(own_max.any(1), first_own, first_any).to(torch.int32)

        # 1b. the receive phase of the miner at pos 1
        lose = None
        if self.selfish:
            omh, withheld, arrival_in, lose = self._selfish_receive(s, h_t, t, new_head)
        elif self.agent:
            omh, withheld, arrival_in = self._agent_receive(s, h_t, t)
        else:
            omh, withheld, arrival_in = s.omh, s.withheld, s.arrival

        # 2. a new head (or no candidate yet) restarts mining on it with a
        # fresh candidate stamped now (startNewMining)
        restart = (new_head != s.head) | ~s.mining
        if lose is not None:
            restart = restart | (lose[:, None] & (mids == SELFISH_ID))
        father = torch.where(restart, new_head, s.father)
        cand_time = torch.where(restart, tc, s.cand_time)
        cand_diff = torch.where(
            restart,
            self._calc_difficulty(_at(s.diff, new_head), _at(s.b_time, new_head),
                                  _at(s.height, new_head), tc),
            s.cand_diff,
        )

        # 3. one Bernoulli trial per miner (mine10ms); the event loop passes
        # the draws its look-ahead already made
        if u is None:
            u = u01(hash32_absorb(h_t, mids, 0xE70))
        success = u < self.thresholds(cand_diff)
        pmb = s.pmb
        if self.agent:
            # the auto-release loop empties minedToSend -> private block None
            pmb = torch.where(withheld.any(1), pmb, -1)
        out = s._replace(
            time=t + BEAT_MS, arrival=arrival_in, head=new_head, father=father,
            cand_time=cand_time, cand_diff=cand_diff,
            # a successful miner stops and restarts on its own block next beat
            mining=~success, pmb=pmb, omh=omh, withheld=withheld,
        )
        return self._append(s, h_t, out, success)

    def _append(self, s: EthPowState, h_t, out: EthPowState, success) -> EthPowState:
        """4. Append the found blocks to the table (capacity-guarded: slot B
        is dropped) and run the private miner's on_mined_block; `s` is the
        state before the beat, `out` after its trial."""
        t = s.time
        r, m, b = t.shape[0], self.m, self.b_max
        mids = self.mids
        tc = t[:, None]
        father, cand_diff = out.father, out.cand_diff
        omh, withheld, pmb = out.omh, out.withheld, out.pmb
        rank = success.to(torch.int32).cumsum(1, dtype=torch.int32) - 1
        idx = s.n_blocks[:, None] + rank
        fits = success & (idx < b)
        slot = torch.where(fits, idx, b)
        new_td = _at(s.td, father) + cand_diff
        # arrivals: the producer now, everyone else at t+1+latency
        from_idx = mids.repeat_interleave(m).expand(r, m * m)
        to_idx = mids.repeat(m).expand(r, m * m)
        ev_seed = to_i32(hash32_absorb(h_t, from_idx, 0xB10C))  # hash32(seed, t, from, tag)
        lat = vec_latency(self.latency, self._static(r), from_idx, to_idx,
                          pseudo_delta(to_idx, ev_seed))
        arr = (tc + 1 + lat).reshape(r, m, m)
        eye = torch.eye(m, dtype=torch.bool, device=self.device)
        arr = torch.where(eye, t[:, None, None], arr)
        if self.selfish or self.agent:
            # the private miner withholds: its block reaches only itself
            arr[:, SELFISH_ID] = torch.where(mids == SELFISH_ID, tc, INT32_MAX)

        # 4b. on_mined_block of the private miner
        if self.selfish or self.agent:
            sm = SELFISH_ID
            k = idx[:, sm]
            mined_ok = success[:, sm] & fits[:, sm]
            withheld = _put(withheld, torch.where(mined_ok, k, b)[:, None], True)
            pmb = torch.where(mined_ok, k, pmb)
        if self.selfish:
            f_sm = father[:, sm]
            hk = _at(s.height, f_sm) + 1
            td_k = new_td[:, sm]
            delta_pm = hk - (_at(s.height, omh) - 1)
            depth2 = (_at(s.producer, f_sm) == sm) & (_at(s.producer, _at(s.parent, f_sm)) != sm)
            publish0 = mined_ok & (delta_pm == 0) & depth2
            omh = torch.where(publish0 & (td_k >= _at(s.td, omh)), k, omh)
            withheld = torch.where(publish0[:, None], False, withheld)

        return out._replace(
            n_blocks=s.n_blocks + fits.sum(1, dtype=torch.int32),
            parent=_put(s.parent, slot, father),
            height=_put(s.height, slot, _at(s.height, father) + 1),
            producer=_put(s.producer, slot, mids.expand(r, m)),
            b_time=_put(s.b_time, slot, out.cand_time),
            diff=_put(s.diff, slot, cand_diff),
            td=_put(s.td, slot, new_td),
            arrival=_put(out.arrival, slot, arr),
            overflowed=s.overflowed + (success & ~fits).sum(1, dtype=torch.int32),
            blocks_mined=s.blocks_mined + success.to(torch.int32),
            pmb=pmb,
            omh=omh,
            withheld=withheld,
        )

    # -- the loops -----------------------------------------------------------
    def _next_events(self, s: EthPowState, h_seed, force: bool):
        """Each replica's next event beat at or after its clock T: T itself
        when forced or when a miner is not mining; the first beat at or
        after the next arrival past T-10; the first beat of the next
        CHUNK_BEATS whose trial succeeds.  INT32_MAX where none lies inside
        the chunk (int64 [R]).  Also returns the chunk's trial draws
        [R, CHUNK_BEATS, M]."""
        t = s.time.to(torch.int64)
        never = torch.full_like(t, INT32_MAX)
        e = t if force else torch.where(s.mining.all(1), never, t)
        seen = (s.time - BEAT_MS)[:, None, None]
        nxt = torch.where(s.arrival > seen, s.arrival, INT32_MAX).amin((1, 2)).to(torch.int64)
        e_arr = t + BEAT_MS * _floor_div((nxt - t).clamp(min=0) + BEAT_MS - 1, BEAT_MS)
        e = torch.minimum(e, torch.where(nxt < INT32_MAX, e_arr, never))
        k = CHUNK_BEATS
        beats = s.time[:, None] + BEAT_MS * torch.arange(k, dtype=torch.int32, device=self.device)
        u = u01(hash32_absorb(h_seed[:, :, None], beats[:, :, None], self.mids, 0xE70))
        hit = (u < self.thresholds(s.cand_diff)[:, None, :]).any(2)
        first = hit.to(torch.int32).argmax(1).to(torch.int64)
        return torch.minimum(e, torch.where(hit.any(1), t + BEAT_MS * first, never)), u

    def run_ms(self, states: EthPowState, ms: int) -> EthPowState:
        """Advance each replica `ms` ms: beats at time, time+10, ... while
        below time + ms (the JAX package's `run_ms` while_loop), by the
        event loop of the module docstring.  The clock ends at the first
        beat at or after time + ms.  Afterwards `jump_stats` holds the
        iteration count and each replica's full beats."""
        s = states
        end = s.time.to(torch.int64) + ms
        final = s.time + BEAT_MS * _floor_div((end - s.time).clamp(min=0) + BEAT_MS - 1,
                                              BEAT_MS).to(torch.int32)
        beats = torch.zeros_like(s.time)
        h_seed = hash32_absorb(HASH32_START, s.seed[:, None])  # the seed never changes
        iterations, force = 0, True
        while True:
            t = s.time.to(torch.int64)
            alive = t < end
            if not bool(alive.any()):
                break
            e, u = self._next_events(s, h_seed, force)
            force = False
            stop = torch.minimum(final.to(torch.int64), t + BEAT_MS * CHUNK_BEATS)
            full = alive & (e < stop)
            moved = s._replace(time=torch.where(full, e, torch.where(alive, stop, t))
                               .to(torch.int32))
            # the beat's trial draws are the look-ahead's at its offset
            j = _floor_div(e - t, BEAT_MS).clamp(0, CHUNK_BEATS - 1)
            u = u.gather(1, j[:, None, None].expand(-1, 1, self.m))[:, 0]
            s = _select(full, self._beat(moved, u, h_seed), moved)
            beats = beats + full.to(torch.int32)
            iterations += 1
        self.jump_stats = {"iterations": iterations, "beats": beats}
        return s

    def run_ms_beats(self, states: EthPowState, ms: int) -> EthPowState:
        """The per-beat loop, the JAX package's form: one full beat every
        10 ms for every replica below its horizon."""
        s = states
        end = s.time + ms
        while True:
            alive = s.time < end
            if not bool(alive.any()):
                return s
            s = _select(alive, self._beat(s), s)


def _select(mask: torch.Tensor, new: EthPowState, old: EthPowState) -> EthPowState:
    """Per replica: `new` where mask, else `old`."""
    return EthPowState(*[
        torch.where(mask.view((-1,) + (1,) * (a.dim() - 1)), a, b) for a, b in zip(new, old)])


def replicate_ethpow(state: EthPowState, n_replicas: int, seeds=None) -> EthPowState:
    """Tile a single-replica state along a new leading replica axis, each
    replica with its own seed (0..R-1 by default)."""
    if seeds is None:
        seeds = np.arange(n_replicas, dtype=np.int32)
    tiled = EthPowState(*[a.unsqueeze(0).expand((n_replicas,) + tuple(a.shape)).contiguous()
                          for a in state])
    return tiled._replace(seed=torch.as_tensor(np.asarray(seeds, np.int32),
                                               device=state.seed.device))


def _host(state: EthPowState, replica: Optional[int]) -> dict:
    out = {f: v.detach().cpu().numpy() for f, v in state._asdict().items()}
    return out if replica is None else {f: v[replica] for f, v in out.items()}


def chain_producers(state: EthPowState, replica: Optional[int] = None) -> np.ndarray:
    """Host-side: producer ids along the PUBLIC winning chain, tip to
    genesis (exclusive); the tip is the best block the honest observer
    (miner 0) has received."""
    h = _host(state, replica)
    n = int(h["n_blocks"])
    td, parent, producer = h["td"], h["parent"], h["producer"]
    known = h["arrival"][:n, 0] <= int(h["time"])
    cur = int(np.argmax(np.where(known, td[:n], -1.0)))
    out = []
    while cur != 0:
        out.append(int(producer[cur]))
        cur = int(parent[cur])
    return np.asarray(out, np.int32)


def selfish_revenue_ratio(state: EthPowState, replica: Optional[int] = None) -> float:
    """Share of winning-chain blocks produced by the miner at pos 1."""
    pr = chain_producers(state, replica)
    return float((pr == SELFISH_ID).mean()) if len(pr) else 0.0


def chain_intervals(state: EthPowState, replica: Optional[int] = None) -> np.ndarray:
    """Host-side: proposal-time gaps along the winning chain."""
    h = _host(state, replica)
    n = int(h["n_blocks"])
    td, parent, b_time = h["td"], h["parent"], h["b_time"]
    cur = int(np.argmax(td[:n]))
    times = []
    while cur != 0:
        times.append(int(b_time[cur]))
        cur = int(parent[cur])
    times.append(0)
    times.reverse()
    return np.diff(np.asarray(times))
