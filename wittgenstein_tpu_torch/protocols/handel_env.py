"""BatchedAttackEnv: the Handel Byzantine attacker as R lockstep environments.

Port of the JAX package's protocols/handel_env.py.  The adversary controls
a fixed bloc of live aggregators (the top of the live list).  At every
`decision_ms` boundary the policy chooses, per replica, whether the bloc
is SILENT for the coming step — withholding its signatures and relaying
nothing — or participates honestly.  The toggle is fault-lane data: the
replica's Byzantine-silence window flips between [0, INT_MAX) (active)
and [INT_MAX, INT_MAX) (never), so one run serves every replica's choice.
Silence acts at the engine's send choke point, which every send crosses,
Handel's channel commits included.

Reward is the ATTACKER's objective: the fraction of statically-live nodes
whose aggregation is still incomplete.

With `net=None, state=None` the environment builds the registry default,
`registry_batched_protocols.get("handel").factory()`: Handel at 64 nodes
at the flagship parameters with the score cache on, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..engine.core import replicate_state
from ..faults.state import INT_MAX, FaultConfig

BYZANTINE_ONLY = FaultConfig(crashes=False, partitions=False, drops=False, delays=False)


class BatchedAttackEnv:
    """R lockstep Handel-attacker environments."""

    def __init__(
        self,
        net=None,
        state=None,
        n_replicas: int = 8,
        decision_ms: int = 100,
        horizon_ms: int = 1000,
        n_silent: Optional[int] = None,
        seed: int = 0,
        device=None,  # for the default build: None = CUDA, "cpu" the CPU
    ):
        if (net is None) != (state is None):
            raise ValueError("pass both of (net, state) or neither")
        if net is None:
            from ..core.registries import registry_batched_protocols

            net, state = registry_batched_protocols.get("handel").factory(device=device)
        if decision_ms <= 0:
            raise ValueError(f"decision_ms={decision_ms} must be positive")
        if horizon_ms % decision_ms != 0:
            raise ValueError(
                f"horizon_ms={horizon_ms} must be a multiple of decision_ms={decision_ms}"
            )
        self.n_replicas = int(n_replicas)
        self.decision_ms = int(decision_ms)
        self.horizon_ms = int(horizon_ms)
        self.seed = int(seed)

        # the environment sets only the Byzantine lane (reset starts from the
        # neutral schedule); the other lanes would stay neutral, so running
        # them would change no leaf (the JAX package arms all five)
        self.net, self._fstate = net.with_faults(state, BYZANTINE_ONLY)
        live = np.flatnonzero(~state.down.cpu().numpy())
        if n_silent is None:
            n_silent = max(1, len(live) // 5)
        if not 0 < n_silent <= len(live):
            raise ValueError(f"n_silent={n_silent} outside (0, live={len(live)}]")
        # the adversary bloc: the top of the live list
        self.silent_nodes = live[len(live) - int(n_silent):]
        self._states = None

    def _transition(self, states, actions: torch.Tensor):
        on = actions.to(torch.bool)  # [R]: silent for this step?
        fs = states.faults._replace(
            byz_start=torch.where(on, 0, INT_MAX).to(torch.int32),
            byz_end=torch.full_like(states.faults.byz_end, INT_MAX),
        )
        return self.net.run_ms_batched(states._replace(faults=fs), self.decision_ms)

    # -- gym-style surface ---------------------------------------------------
    def _observe(self, states):
        down = states.down.cpu().numpy()
        done = states.done_at.cpu().numpy()
        live = ~down
        n_live = np.maximum(live.sum(axis=1), 1)
        done_frac = ((done > 0) & live).sum(axis=1) / n_live
        return {
            "time": states.time.cpu().numpy(),
            "done_frac": done_frac,
            "undone_frac": 1.0 - done_frac,
            "msg_received_mean": np.where(live, states.msg_received.cpu().numpy(), 0).sum(axis=1)
            / n_live,
        }

    def reset(self):
        silent = torch.zeros(self.net.n_nodes, dtype=torch.bool, device=self.net.device)
        silent[torch.as_tensor(self.silent_nodes, device=self.net.device)] = True
        st = self._fstate._replace(faults=self._fstate.faults._replace(byz_silent=silent))
        self._states = replicate_state(
            st, self.n_replicas, seeds=np.arange(self.seed, self.seed + self.n_replicas))
        return self._observe(self._states)

    def step(self, actions):
        """actions: int/bool array [R] — 1 = adversary bloc silent for the
        coming `decision_ms`.  Returns (obs, reward, info); reward is the
        live-node undone fraction (the attacker maximizes it)."""
        if self._states is None:
            raise RuntimeError("call reset() first")
        acts = torch.as_tensor(np.asarray(actions, np.int32).reshape(self.n_replicas),
                               device=self.net.device)
        self._states = self._transition(self._states, acts)
        obs = self._observe(self._states)
        return obs, obs["undone_frac"], {"time": obs["time"]}

    @property
    def states(self):
        return self._states
