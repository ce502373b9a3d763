"""The port's batched-protocol registry against the JAX package's.

The same names, modules, notes and contract flags; every factory's
initial state equals the JAX factory's in every leaf (words as int32 bit
views, the p2pflood_faults entry's fault side-car included), and
ETHPoW's entry raises in both.  The attack environment's default goes
through the registry's "handel" entry and gives the JAX environment's
first step.
"""

import numpy as np
import pytest
import torch

from test_torch_paxos import assert_same_state, jax_numpy
from wittgenstein_tpu.core.registries import registry_batched_protocols as jreg
from wittgenstein_tpu.protocols.handel_env import BatchedAttackEnv as JEnv
from wittgenstein_tpu_torch.core.registries import registry_batched_protocols as treg
from wittgenstein_tpu_torch.interop import state_to_numpy
from wittgenstein_tpu_torch.protocols.handel_env import BatchedAttackEnv as TEnv

BUILDABLE = [n for n in jreg.names() if jreg.get(n).contract_checks]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_entries_match():
    assert treg.names() == jreg.names() and len(treg.names()) == 17
    assert treg.modules() == jreg.modules()
    for j, t in zip(jreg.entries(), treg.entries()):
        assert (t.name, t.module, t.contract_checks, t.note) == (
            j.name, j.module, j.contract_checks, j.note)
    with pytest.raises(ValueError, match="duplicate"):
        treg.register(treg.get("paxos"))
    for reg in (treg, jreg):
        with pytest.raises(KeyError):
            reg.get("no_such_protocol")


@pytest.mark.parametrize("name", BUILDABLE)
def test_factory_initial_state_matches(name):
    jnet, jstate = jreg.get(name).factory()
    tnet, tstate = treg.get(name).factory(device="cpu")
    assert tnet.device.type == "cpu"
    assert tnet.n_nodes == jnet.n_nodes
    assert type(tnet.protocol).__name__ == type(jnet.protocol).__name__
    assert_same_state(jax_numpy(jstate), state_to_numpy(tstate), name)


def test_ethpow_entry_raises():
    for reg, kw in ((jreg, {}), (treg, {"device": "cpu"})):
        with pytest.raises(NotImplementedError, match="standalone"):
            reg.get("ethpow").factory(**kw)


def test_attack_env_default_is_the_registry_entry():
    """BatchedAttackEnv() builds the registry's "handel" entry; its reset
    and first step equal the JAX environment's."""
    jenv = JEnv(n_replicas=2, decision_ms=100, horizon_ms=200)
    tenv = TEnv(n_replicas=2, decision_ms=100, horizon_ms=200, device="cpu")
    _, state = treg.get("handel").factory(device="cpu")
    assert torch.equal(tenv._fstate.done_at, state.done_at)
    assert tenv.net.protocol.SCORE_CACHE and tenv.net.n_nodes == 64
    for want, got in ((jenv.reset(), tenv.reset()),
                      (jenv.step(np.array([1, 0]))[0], tenv.step(np.array([1, 0]))[0])):
        assert set(want) == set(got)
        for k in want:
            assert want[k].dtype == got[k].dtype and np.array_equal(want[k], got[k]), k
    assert_same_state(jax_numpy(jenv.states), state_to_numpy(tenv.states), "first step")
