"""BatchedMinerEnv in the port against the JAX package.

At `create_agent`'s configuration (the CITIES builder, a fixed 1000 ms
latency, 10 miners, the agent at pos 1 with 45% of the hash power), a
reset and a sequence of steps under a fixed action schedule — keep
withholding, release everything when behind, and now and then one more
than the withheld count, the restamp case — give observation dicts equal
to the JAX environment's at every step, key for key in dtype and bits,
and the same state leaves at the end.  The port counts the observation
walks by pointer doubling; `chain_count` is held to the scalar walks on
random tables.  The decision grid check raises as in the JAX package.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_paxos import assert_same_state
from wittgenstein_tpu.protocols.ethpow import ETHPoWParameters as JParams
from wittgenstein_tpu.protocols.ethpow_env import BatchedMinerEnv as JEnv
from wittgenstein_tpu_torch.core.registries import CITIES, builder_name
from wittgenstein_tpu_torch.interop import state_to_numpy
from wittgenstein_tpu_torch.protocols.ethpow import ETHPoWParameters as TParams
from wittgenstein_tpu_torch.protocols.ethpow_env import BatchedMinerEnv as TEnv
from wittgenstein_tpu_torch.protocols.ethpow_env import chain_count

AGENT = dict(node_builder_name=builder_name(CITIES, True, 0),
             network_latency_name="NetworkFixedLatency(1000)", number_of_miners=10,
             byz_class_name="ETHMinerAgent", byz_mining_ratio=0.45)
REPLICAS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _policy(obs: dict, step: int) -> np.ndarray:
    """Release everything when behind, else withhold; every seventh step
    one more than the withheld count (Java's restamp case)."""
    if step % 7 == 3:
        return (obs["n_withheld"] + 1).astype(np.int32)
    return np.where(obs["lag"] > 0, obs["n_withheld"], 0).astype(np.int32)


def _assert_same_obs(want: dict, got: dict, tag: str) -> None:
    assert set(want) == set(got), tag
    for k in want:
        assert want[k].dtype == got[k].dtype and want[k].shape == got[k].shape, f"{tag}: {k}"
        assert np.array_equal(want[k], got[k]), f"{tag}: {k} {want[k]} {got[k]}"


@pytest.mark.parametrize("decision_ms, steps", [(1000, 40), (10, 30), (250, 24)])
def test_reset_and_steps_match_jax(decision_ms, steps):
    jenv = JEnv(JParams(**AGENT), n_replicas=REPLICAS, decision_ms=decision_ms, seeds=[0, 3, 8])
    tenv = TEnv(TParams(**AGENT), n_replicas=REPLICAS, decision_ms=decision_ms, seeds=[0, 3, 8],
                device="cpu")
    jo, to = jenv.reset(), tenv.reset()
    _assert_same_obs(jo, to, "reset")
    seen = {k: False for k in ("mined_block", "other_new_head", "other_private_head")}
    for i in range(steps):
        acts = _policy(jo, i)
        jo, jr, ji = jenv.step(acts)
        to, tr, ti = tenv.step(acts)
        _assert_same_obs(jo, to, f"step {i}")
        assert np.array_equal(jr, tr) and np.array_equal(ji["overflowed"], ti["overflowed"])
        for k in seen:
            seen[k] |= bool(to[k].any())
    want = {f.name: np.asarray(getattr(jenv.states, f.name))
            for f in dataclasses.fields(jenv.states)}
    assert_same_state(want, state_to_numpy(tenv.states), "final state")
    assert (to["time"] == 1 + steps * decision_ms).all()
    if decision_ms == 1000:
        assert all(seen.values()), seen


def test_decision_grid_and_strategy_checks():
    for bad in (0, -10, 15, 1005):
        for env in (JEnv, TEnv):
            kw = {} if env is JEnv else {"device": "cpu"}
            params = (JParams if env is JEnv else TParams)(**AGENT)
            with pytest.raises(ValueError, match="multiple"):
                env(params, decision_ms=bad, **kw)
    with pytest.raises(ValueError, match="ETHMinerAgent"):
        TEnv(TParams(number_of_miners=10, byz_class_name="ETHSelfishMiner",
                     byz_mining_ratio=0.45), device="cpu")
    env = TEnv(TParams(**AGENT), n_replicas=2, decision_ms=1000, device="cpu")
    with pytest.raises(RuntimeError, match="reset"):
        env.step(np.zeros(2, np.int32))


def _scalar_count(par, start, stop, val):
    i, acc = int(start), 0
    while not stop[i]:
        acc += int(val[i])
        i = int(par[i])
    return acc


@pytest.mark.parametrize("seed", range(4))
def test_chain_count_equals_the_scalar_walk(seed):
    """Random forests of parent pointers (parent below the child, genesis
    its own parent) and random stops: pointer doubling counts what the
    walk counts, also from a stop and over chains of the whole table."""
    rng = np.random.default_rng(seed)
    r, b = 6, 64 if seed < 3 else 512
    par = np.zeros((r, b), np.int32)
    for i in range(1, b):
        par[:, i] = rng.integers(max(0, i - 3), i, r) if seed % 2 else i - 1
    stop = rng.random((r, b)) < (0.1 if seed < 2 else 0.0)
    stop[:, 0] = True
    val = rng.integers(0, 3, (r, b)).astype(np.int32)
    start = rng.integers(0, b, r).astype(np.int32)
    start[0] = b - 1
    got = chain_count(torch.from_numpy(par), torch.from_numpy(start), torch.from_numpy(stop),
                      torch.from_numpy(val)).numpy()
    want = [_scalar_count(par[k], start[k], stop[k], val[k]) for k in range(r)]
    assert got.tolist() == want
