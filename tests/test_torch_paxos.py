"""Batched Paxos in the port against the JAX package, leaf for leaf.

Paxos is event-driven on the 512-row wheel: every jump reads the wheel's
occupancy (pack_occupied and lowest_set_bit, their plain versions on the
CPU), the quiescence test of `stop_when_done` counts it with
popcount_words, and the 1000-ms proposer timeouts wait in the overflow
lane.  Both packages build the population from the same JavaRandom
stream — which the proposers' init-time sends move between one
proposer's construction and the next — and every leaf, the wheel and the
overflow lane included, must agree exactly.
"""

import jax
import numpy as np
import pytest
import torch

from wittgenstein_tpu.engine import replicate_state as jreplicate
from wittgenstein_tpu.protocols.paxos import PaxosParameters as JParams
from wittgenstein_tpu.protocols.paxos_batched import make_paxos as jmake
from wittgenstein_tpu_torch.engine import core as tcore
from wittgenstein_tpu_torch.engine import replicate_state as treplicate
from wittgenstein_tpu_torch.interop import state_from_numpy, state_to_numpy
from wittgenstein_tpu_torch.protocols.paxos import PaxosParameters as TParams
from wittgenstein_tpu_torch.protocols.paxos import paxos_roles
from wittgenstein_tpu_torch.protocols.paxos_batched import make_paxos as tmake

REPLICAS = 2
SIM_MS = 5000
ROLE_FIELDS = ("is_acc", "is_prop", "rank", "value_proposed", "acc_ids", "prop_ids")
SIZES = {"defaults": (3, 3), "5+3": (5, 3)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _inference_mode():
    """The port's runs without autograd bookkeeping, as on the card."""
    with torch.inference_mode():
        yield


def jax_numpy(state) -> dict:
    d = jax.tree_util.tree_map(np.asarray, state)._asdict()
    d["proto"] = dict(d["proto"])
    if d["faults"] != ():
        d["faults"] = d["faults"]._asdict()
    return d


def assert_same_state(want: dict, got: dict, tag: str) -> None:
    """Every leaf equal in name, dtype, shape and bits."""
    assert set(want) == set(got), tag
    for f, w in want.items():
        g = got[f]
        if isinstance(w, dict):  # proto, and a fault side-car's leaves
            assert set(w) == set(g), f"{tag}: {f} keys"
            for k in w:
                assert w[k].dtype == g[k].dtype and w[k].shape == g[k].shape, f"{tag}: {f}.{k}"
                assert np.array_equal(w[k], g[k]), f"{tag}: {f}.{k} differs"
        elif isinstance(w, np.ndarray):
            assert w.dtype == g.dtype and w.shape == g.shape, f"{tag}: {f} dtype/shape"
            assert np.array_equal(w, g), f"{tag}: {f} differs"
        else:
            assert g == w == (), f"{tag}: side-car {f}"


def _both(size):
    acc, prop = SIZES[size]
    jnet, jstate = jmake(JParams(acceptor_count=acc, proposer_count=prop))
    tnet, tstate = tmake(TParams(acceptor_count=acc, proposer_count=prop), device="cpu")
    return jnet, jstate, tnet, tstate


@pytest.mark.parametrize("size", list(SIZES))
def test_roles_and_initial_state(size):
    jnet, jstate, tnet, tstate = _both(size)
    for f in ROLE_FIELDS:
        want = np.asarray(getattr(jnet.protocol, f))
        got = getattr(tnet.protocol, f).numpy()
        assert want.dtype == got.dtype and np.array_equal(want, got), f
    _, roles = paxos_roles(TParams(*SIZES[size]))
    assert np.array_equal(roles["value_proposed"], np.asarray(jnet.protocol.value_proposed))
    assert (tnet.wheel_rows, tnet.wheel_slots, tnet.overflow_capacity) == (512, 64, 256)
    assert_same_state(jax_numpy(jreplicate(jstate, 1)), state_to_numpy(treplicate(tstate, 1)),
                      "initial state")


@pytest.mark.parametrize("stop", [False, True], ids=["horizon", "stop_when_done"])
def test_run_matches(stop):
    jnet, jstate, tnet, tstate = _both("defaults")
    want = jax_numpy(jnet.run_ms_batched(jreplicate(jstate, REPLICAS), SIM_MS,
                                         stop_when_done=stop))
    got = state_to_numpy(tnet.run_ms_batched(treplicate(tstate, REPLICAS), SIM_MS, stop))
    assert_same_state(want, got, f"after {SIM_MS} ms")
    # replica 0: the JAX package's seed-0 run
    assert got["done_at"][0, 3:].tolist() == [487, 912, 226]
    assert (got["proto"]["value_accepted"][0, 3:] == 95).all()
    assert int(got["msg_sent"][0].sum()) == 78
    assert int(got["msg_received"][0].sum()) == (77 if stop else 78)
    assert (got["dropped"] == 0).all() and (got["time"] == SIM_MS).all()


def test_run_ms_one_replica():
    """The JAX package's single-replica run_ms against the port's batch of
    one (replica 0 carries the state's own seed 0)."""
    jnet, jstate, tnet, tstate = _both("defaults")
    j = jax.tree_util.tree_map(lambda a: np.asarray(a)[None], jnet.run_ms(jstate, SIM_MS))
    want = jax_numpy(j)
    got = state_to_numpy(tnet.run_ms(treplicate(tstate, 1), SIM_MS))
    assert_same_state(want, got, "run_ms")
    assert got["done_at"][0, 3:].tolist() == [487, 912, 226]


def test_five_acceptors():
    jnet, jstate, tnet, tstate = _both("5+3")
    want = jax_numpy(jnet.run_ms_batched(jreplicate(jstate, REPLICAS), SIM_MS, True))
    got = state_to_numpy(tnet.run_ms_batched(treplicate(tstate, REPLICAS), SIM_MS, True))
    assert_same_state(want, got, "5 + 3")
    assert got["done_at"][0, 5:].tolist() == [637, 447, 261]
    assert (got["proto"]["value_accepted"][0, 5:] == 143).all()


def test_dueling_proposers_stay_undecided():
    """Seeds 15639 and 16118 (found in a 16384-replica run) leave
    proposers 0 and 1 in progress at 5000 ms in both packages: each one's
    commit is rejected after the other's proposal, round after round,
    while proposer 2 has accepted the value.  Seed 3 decides."""
    jnet, jstate, tnet, tstate = _both("defaults")
    seeds = [15639, 16118, 3]
    want = jax_numpy(jnet.run_ms_batched(
        jreplicate(jstate, 3, seeds=np.array(seeds, np.int32)), SIM_MS, stop_when_done=True))
    got = state_to_numpy(tnet.run_ms_batched(treplicate(tstate, 3, seeds=seeds), SIM_MS, True))
    assert_same_state(want, got, "dueling proposers")
    p = got["proto"]
    assert p["value_accepted"][:, 3:].tolist() == [[-1, -1, 95], [-1, -1, 95], [95, 95, 95]]
    assert p["prop_ip"][:2, 3:5].all() and (p["rej2_count"][:2, 3:5] >= 13).all()


def test_interop_handover():
    """The JAX package runs 300 ms (proposals in flight, timeouts waiting
    in the overflow lane), the port takes its state over, and both run
    1500 ms more."""
    jnet, jstate, tnet, _ = _both("defaults")
    js = jnet.run_ms_batched(jreplicate(jstate, REPLICAS), 300)
    ts = state_from_numpy(jax_numpy(js), "cpu")
    assert_same_state(jax_numpy(js), state_to_numpy(ts), "handover")
    assert (jax_numpy(js)["ovf_valid"].sum(-1) > 0).all()
    js = jnet.run_ms_batched(js, 1500)
    ts = tnet.run_ms_batched(ts, 1500)
    assert_same_state(jax_numpy(js), state_to_numpy(ts), "after the handover")


def test_jump_loop_calls_the_occupancy_kernels(monkeypatch):
    """Every jump reads the wheel through pack_occupied and lowest_set_bit,
    and the stop_when_done test counts it with popcount_words."""
    calls = {"pack_occupied": 0, "lowest_set_bit": 0, "popcount_words": 0}

    def spy(name):
        real = getattr(tcore, name)

        def wrapped(*a, **k):
            calls[name] += 1
            return real(*a, **k)

        return wrapped

    for name in calls:
        monkeypatch.setattr(tcore, name, spy(name))
    tnet, tstate = tmake(device="cpu")
    out = tnet.run_ms_batched(treplicate(tstate, REPLICAS), SIM_MS, stop_when_done=True)
    it = tnet.jump_stats["iterations"]
    assert (out.proto["value_accepted"][:, 3:] == 95).all()
    # one occupancy pack for each jump and one for each quiescence test
    assert calls["lowest_set_bit"] == it
    assert calls["popcount_words"] >= it
    assert calls["pack_occupied"] == calls["lowest_set_bit"] + calls["popcount_words"]
