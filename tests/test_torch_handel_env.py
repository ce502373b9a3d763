"""BatchedAttackEnv in the port against the JAX package.

The JAX package's own attack-environment case (PingPong, 16 nodes, a
fixed 100 ms latency, 2 replicas, 150 ms steps) and the default
environment (Handel at 64 nodes at the flagship parameters, 2 replicas,
100 ms steps) give the JAX environment's observations at every step
under a schedule that silences the bloc in some replicas and steps and
not in others, and the same state leaves, fault side-car included.  A
silent bloc cuts the traffic it would have sent.
"""

import numpy as np
import pytest
import torch

from test_torch_paxos import assert_same_state, jax_numpy
from wittgenstein_tpu.protocols.handel_env import BatchedAttackEnv as JEnv
from wittgenstein_tpu.protocols.pingpong_batched import make_pingpong as jmake_pp
from wittgenstein_tpu_torch.interop import state_to_numpy
from wittgenstein_tpu_torch.protocols.handel_env import BatchedAttackEnv as TEnv
from wittgenstein_tpu_torch.protocols.pingpong_batched import make_pingpong as tmake_pp

FIXED = "NetworkFixedLatency(100)"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _assert_same_obs(want: dict, got: dict, tag: str) -> None:
    assert set(want) == set(got), tag
    for k in want:
        assert want[k].dtype == got[k].dtype and np.array_equal(want[k], got[k]), f"{tag}: {k}"


def _pingpong_envs(**kw):
    jenv = JEnv(*jmake_pp(16, network_latency_name=FIXED), **kw)
    tenv = TEnv(*tmake_pp(16, network_latency_name=FIXED, device="cpu"), **kw)
    return jenv, tenv


def _run(jenv, tenv, schedule):
    _assert_same_obs(jenv.reset(), tenv.reset(), "reset")
    assert np.array_equal(jenv.silent_nodes, tenv.silent_nodes)
    for i, acts in enumerate(schedule):
        jo, jr, ji = jenv.step(np.array(acts))
        to, tr, ti = tenv.step(np.array(acts))
        _assert_same_obs(jo, to, f"step {i}")
        assert np.array_equal(jr, tr) and np.array_equal(ji["time"], ti["time"])
    assert_same_state(jax_numpy(jenv.states), state_to_numpy(tenv.states), "final state")
    return to


def test_pingpong_case():
    """The JAX package's TestAttackEnv PingPong case: silent in both steps,
    then honest in both, on fresh resets; the silent run carries less
    traffic."""
    jenv, tenv = _pingpong_envs(n_replicas=2, decision_ms=150, horizon_ms=300)
    traffic = []
    for acts in ([1, 1], [0, 0]):
        o = _run(jenv, tenv, [acts, acts])
        assert np.all(o["time"] == 300)
        traffic.append(float(o["msg_received_mean"].sum()))
    assert traffic[0] < traffic[1]


def test_pingpong_mixed_schedule():
    jenv, tenv = _pingpong_envs(n_replicas=3, decision_ms=100, horizon_ms=300, n_silent=5,
                                seed=4)
    _run(jenv, tenv, [[1, 0, 1], [0, 1, 1], [1, 1, 0]])


def test_handel_default_environment():
    """Handel at 64 nodes (the registry default), 2 replicas x 3 steps of
    100 ms: replica 0 silent, then honest, then silent; replica 1 the
    other way round."""
    jenv = JEnv(n_replicas=2, decision_ms=100, horizon_ms=300)
    tenv = TEnv(n_replicas=2, decision_ms=100, horizon_ms=300, device="cpu")
    assert tenv.net.n_nodes == 64 and tenv.net.protocol.SCORE_CACHE
    o = _run(jenv, tenv, [[1, 0], [0, 1], [1, 0]])
    assert (o["time"] == 300).all()
    f = state_to_numpy(tenv.states)["faults"]
    assert (f["dropped_by_fault"].sum(-1) > 0).all()


def test_checks():
    net, state = tmake_pp(16, network_latency_name=FIXED, device="cpu")
    with pytest.raises(ValueError, match="both"):
        TEnv(net=net)
    with pytest.raises(ValueError, match="positive"):
        TEnv(net, state, decision_ms=0)
    with pytest.raises(ValueError, match="multiple"):
        TEnv(net, state, decision_ms=150, horizon_ms=200)
    with pytest.raises(ValueError, match="n_silent"):
        TEnv(net, state, n_silent=17)
    env = TEnv(net, state, n_replicas=2, decision_ms=100, horizon_ms=200)
    with pytest.raises(RuntimeError, match="reset"):
        env.step(np.zeros(2))
