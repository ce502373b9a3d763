"""BatchedMinerEnv: the selfish-mining RL bridge (ETHMinerAgent.java:38-225)
as R lockstep environments.

Port of the JAX package's protocols/ethpow_env.py.  Each step applies
`actions[R]` — how many of the OLDEST withheld private blocks each
replica's agent releases (send_mined_blocks, ETHMinerAgent.java:68-88; 0
keeps withholding) — then advances every replica `decision_ms` through
`BatchedEthPow.run_ms`, where mining, fork choice, arrivals and the
agent's auto-release of overtaken blocks run.  The observations mirror
the oracle bridge's queries: `advance` (getAdvance), `secret_advance`,
`lag`, `i_am_ahead`, the withheld count, head height, `reward_ratio` (the
agent's share of the public winning chain) and the three decision flags
(ON_MINED_BLOCK / ON_OTHER_NEW_HEAD / ON_OTHER_PRIVATE_HEAD since the
previous step).

The JAX package walks the chains with scalar `lax.while_loop`s per
replica; the port counts along the `parent` pointers by pointer doubling
over the whole table at once (ceil(log2 B) rounds of exact integer sums),
with the same numbers.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .ethpow import ETHPoWParameters
from .ethpow_batched import (
    BEAT_MS,
    SELFISH_ID,
    BatchedEthPow,
    EthPowState,
    _at,
    replicate_ethpow,
)


def chain_count(parent: torch.Tensor, start: torch.Tensor, stop: torch.Tensor,
                val: torch.Tensor) -> torch.Tensor:
    """Per replica, the sum of `val` over the blocks from `start` [R] toward
    genesis along `parent` [R, B], up to (excluding) the first block where
    `stop` [R, B] holds.  Pointer doubling: a stop block jumps to itself
    and adds 0, so after 2^k >= B rounds every walk has reached its stop
    (a chain has fewer than B blocks); int32 sums, exact."""
    b = parent.shape[1]
    ids = torch.arange(b, dtype=parent.dtype, device=parent.device)
    jump = torch.where(stop, ids, parent).to(torch.int64)
    acc = torch.where(stop, 0, val).to(torch.int32)
    for _ in range(max(1, math.ceil(math.log2(b)))):
        acc = acc + acc.gather(1, jump)
        jump = jump.gather(1, jump)
    return acc.gather(1, start.to(torch.int64)[:, None])[:, 0]


class BatchedMinerEnv:
    """R lockstep selfish-mining environments."""

    def __init__(
        self,
        params: Optional[ETHPoWParameters] = None,
        n_replicas: int = 8,
        decision_ms: int = 10,
        b_max: int = 512,
        seed: int = 0,
        seeds=None,
        device=None,  # None = CUDA; "cpu" runs on the CPU
    ):
        if params is None:
            params = ETHPoWParameters(byz_class_name="ETHMinerAgent")
        if not (params.byz_class_name or "").endswith("ETHMinerAgent"):
            raise ValueError("BatchedMinerEnv requires byz_class_name=ETHMinerAgent")
        if decision_ms <= 0 or decision_ms % BEAT_MS != 0:
            # the run advances in BEAT_MS beats until time >= end: another
            # step would overshoot every step and drift off the grid
            raise ValueError(
                f"decision_ms={decision_ms} must be a positive multiple of "
                f"the {BEAT_MS} ms mining beat"
            )
        self.net = BatchedEthPow(params, b_max=b_max, seed=seed, device=device)
        self.n_replicas = n_replicas
        self.decision_ms = decision_ms
        self._seeds = seeds
        self._states: Optional[EthPowState] = None

    def _transition(self, s: EthPowState, actions: torch.Tensor) -> EthPowState:
        return self.net.run_ms(self.net.agent_apply_action(s, actions), self.decision_ms)

    # -- observations --------------------------------------------------------
    def _observe(self, s: EthPowState, prev: EthPowState) -> dict:
        sm = SELFISH_ID
        hgt, prod, par, td = s.height, s.producer, s.parent, s.td
        r, b = hgt.shape
        ids = torch.arange(b, dtype=torch.int32, device=hgt.device)
        at_genesis = ids == 0
        head = s.head[:, sm]
        own = prod == sm
        one = torch.ones_like(hgt)
        # advance/lag: consecutive own / other blocks from the head down
        advance = chain_count(par, head, ~own | at_genesis, one)
        lag = chain_count(par, head, own | at_genesis, one)
        ph = torch.where(s.pmb >= 0, _at(hgt, s.pmb.clamp(min=0)), 0)
        h_omh = _at(hgt, s.omh)
        secret_advance = (ph - h_omh).clamp(min=0)
        # reward ratio over the PUBLIC winning chain seen by honest miner 0
        known = s.arrival[:, :, 0] <= s.time[:, None]
        tip = torch.where(known, td, -1.0).argmax(1).to(torch.int32)
        stop = at_genesis.expand(r, b)
        mine = chain_count(par, tip, stop, own.to(torch.int32))
        total = chain_count(par, tip, stop, one)
        ratio = mine.to(torch.float32) / total.clamp(min=1).to(torch.float32)
        prod_head = _at(prod, head)
        ints = {
            "time": s.time,
            "head_height": _at(hgt, head),
            "advance": advance,
            "secret_advance": secret_advance,
            "lag": lag,
            "n_withheld": s.withheld.sum(1, dtype=torch.int32),
        }
        flags = {
            "i_am_ahead": prod_head == sm,
            # what the oracle would have paused on since the previous step
            "mined_block": s.blocks_mined[:, sm] > prev.blocks_mined[:, sm],
            "other_new_head": (s.head[:, sm] != prev.head[:, sm]) & (prod_head != sm),
            "other_private_head": s.omh != prev.omh,
        }
        # one transfer for the integer columns, one for the ratio
        cols = torch.stack([*ints.values(), *[f.to(torch.int32) for f in flags.values()]], 1)
        host = cols.cpu().numpy()
        obs = {k: host[:, j] for j, k in enumerate(ints)}
        obs.update({k: host[:, len(ints) + j].astype(bool) for j, k in enumerate(flags)})
        obs["reward_ratio"] = ratio.cpu().numpy()
        return obs

    # -- gym-style surface ---------------------------------------------------
    def reset(self):
        state = self.net.init_state()
        self._states = replicate_ethpow(state, self.n_replicas, self._seeds)
        return self._observe(self._states, self._states)

    def step(self, actions):
        """actions: int array [R] — oldest withheld blocks to release."""
        if self._states is None:
            raise RuntimeError("call reset() first")
        prev = self._states
        acts = torch.as_tensor(np.asarray(actions, np.int32).reshape(self.n_replicas),
                               device=self.net.device)
        self._states = self._transition(prev, acts)
        obs = self._observe(self._states, prev)
        return obs, obs["reward_ratio"], {"overflowed": self._states.overflowed.cpu().numpy()}

    @property
    def states(self) -> EthPowState:
        return self._states
