"""Batched ENRGossiping in the port against the JAX package.

The port replays ENRGossiping.init and make_enr's schedule on the host
from the oracle's JavaRandom stream (capabilities before each node's
position draw, setPeers, the changing nodes with their `total_peers`
quirk and start draws, then the joiners' capabilities, the t = 0
joiner's wiring, the exit and broadcast draws and the fresh change
draws, and last the joiners' positions).  Every leaf must equal the JAX
package's:

  * the initial state at the reference main's 10-hour horizon (131
    slots), at 4 000 000 ms (59 slots) and for a churn configuration,
    with the t = 0 done marks from `_fully_connected`;
  * that churn configuration x 2 replicas x 12 000 ms, which runs
    births, two exits, capability changes and their re-arms, connects
    past max_peers and swaps (a spy counts them);
  * `_fully_connected` on random states: about 40 slots, random alive
    masks, capability sets and symmetric adjacencies, some nodes
    isolated;
  * the swap scan's argmax and the birth pick's stable sort against
    jnp.argmax / jnp.argsort on int32 rows with forced ties.

One JAX run per case, shared by a module fixture (ENR's step is the JAX
package's most expensive graph per iteration).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_paxos import assert_same_state, jax_numpy
from wittgenstein_tpu.engine import replicate_state as jreplicate
from wittgenstein_tpu.protocols.enr_batched import make_enr as jmake
from wittgenstein_tpu.protocols.enr_gossiping import ENRParameters as JParams
from wittgenstein_tpu_torch.engine import replicate_state as treplicate
from wittgenstein_tpu_torch.interop import state_to_numpy
from wittgenstein_tpu_torch.protocols.enr_batched import birth_order, make_enr as tmake, swap_pick
from wittgenstein_tpu_torch.protocols.enr_gossiping import ENRParameters as TParams

# births every 2000 ms, exits at 8560 and 9469, capability changes at
# 3051 and 5873 re-armed 6000 ms later; max_peers 6 is reached
CHURN = dict(nodes=24, total_peers=4, max_peers=6, number_of_different_capabilities=5,
             cap_per_node=2, cap_gossip_time=3000, time_to_leave=16000, time_to_change=6000,
             changing_nodes=1, discard_time=100)
CHURN_MS = 12_000
REPLICAS = 2
INITIAL = {
    "main-131": ({}, 36_000_000, 131),
    "main-59": ({}, 4_000_000, 59),
    "churn-31": (CHURN, CHURN_MS, 31),
}


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


def _both(kw, horizon):
    jnet, jstate = jmake(JParams(**kw), horizon_ms=horizon, capacity=1024)
    tnet, tstate = tmake(TParams(**kw), horizon_ms=horizon, capacity=1024, device="cpu")
    return jnet, jstate, tnet, tstate


@pytest.mark.parametrize("case", list(INITIAL))
def test_initial_state(case):
    kw, horizon, slots = INITIAL[case]
    jnet, jstate, tnet, tstate = _both(kw, horizon)
    assert tnet.n_nodes == jnet.n_nodes == slots
    got = state_to_numpy(treplicate(tstate, 1))
    assert_same_state(jax_numpy(jreplicate(jstate, 1)), got, f"{case}: initial state")
    alive = got["proto"]["alive"][0]
    assert alive.sum() == (kw or TParams().__dict__)["nodes"] + 1  # with the t = 0 joiner
    assert got["proto"]["last_t"].tolist() == [-1]
    if not kw:  # every node holds all five capabilities: all done at t = 0
        assert (got["done_at"][0] == alive).all()


@pytest.fixture(scope="module")
def churn_run():
    jnet, jstate, tnet, tstate = _both(CHURN, CHURN_MS)
    swaps = []
    remove_worst = tnet.protocol._remove_worst

    def spy(*args):
        j_best, ok = remove_worst(*args)
        swaps.append(int(ok.sum()))
        return j_best, ok

    tnet.protocol._remove_worst = spy
    want = jax_numpy(jnet.run_ms_batched(jreplicate(jstate, REPLICAS), CHURN_MS))
    got = state_to_numpy(tnet.run_ms_batched(treplicate(tstate, REPLICAS), CHURN_MS))
    return want, got, state_to_numpy(treplicate(tstate, REPLICAS)), swaps


def test_churn_run_matches(churn_run):
    want, got, _, _ = churn_run
    assert_same_state(want, got, f"churn: after {CHURN_MS} ms")


def test_churn_run_exercises_churn(churn_run):
    """The churn case runs every path: births, exits, capability changes
    and their re-arms, connects past max_peers and swaps, with nothing
    dropped and a symmetric, loop-free adjacency on the alive slots."""
    _, got, init, swaps = churn_run
    p = got["proto"]
    born_at = init["proto"]["born_at"][0]
    births = (born_at > 0) & (born_at < CHURN_MS)
    assert births.sum() == 5
    assert (p["start_time"][:, births] == born_at[births]).all()
    exited = births & ~p["alive"]
    assert (exited.sum(-1) == 2).all()
    assert (p["change_next"] > init["proto"]["change_next"]).any(-1).all()
    assert (p["records"].sum(-1) == 114).all()
    adj = p["adj"]
    assert (adj == adj.transpose(0, 2, 1)).all() and not adj[:, np.arange(31), np.arange(31)].any()
    assert not (adj.any(-1) & ~p["alive"]).any()
    assert adj.sum(-1).max(-1).tolist() == [8, 10]  # past max_peers 6: same-ms races
    assert sum(swaps) > 0
    assert (got["dropped"] == 0).all()


def _random_protos(rng, m: int, n_caps: int, count: int):
    """Random alive masks, capability sets and symmetric adjacencies; some
    alive nodes isolated, no self-loops, no link on a dead slot."""
    alive = rng.random((count, m)) < 0.8
    caps = rng.random((count, m, n_caps)) < 0.5
    density = rng.uniform(0.05, 0.4, size=(count, 1, 1))
    up = np.triu(rng.random((count, m, m)) < density, 1)
    adj = up | up.transpose(0, 2, 1)
    isolated = rng.random((count, m)) < 0.1
    cut = ~alive | isolated
    adj &= ~cut[:, :, None] & ~cut[:, None, :]
    return {"alive": alive, "caps": caps, "adj": adj}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fully_connected_matches_jax(seed):
    """`_fully_connected` on 40-slot random states (cap_per_node 2 over 5
    capabilities, so the score and the per-capability reach both
    decide)."""
    horizon = 30_000  # 24 nodes + 16 joiner slots
    jnet, _, tnet, _ = _both(CHURN, horizon)
    m = tnet.n_nodes
    assert m == 40
    protos = _random_protos(np.random.default_rng(seed), m, CHURN["number_of_different_capabilities"],
                            8)
    want = np.asarray(jax.jit(jax.vmap(jnet.protocol._fully_connected))(
        {k: jnp.asarray(v) for k, v in protos.items()}))
    t = {k: torch.from_numpy(v) for k, v in protos.items()}
    got = tnet.protocol._fully_connected(t["alive"], t["caps"], t["adj"]).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert 0 < want.sum() < want.size  # both outcomes occur


def test_swap_pick_first_max_on_ties():
    rng = np.random.default_rng(3)
    s = rng.integers(-3, 4, size=(64, 41)).astype(np.int32)
    s[:8] = 2  # whole rows tied
    s[8:16] = np.where(rng.random((8, 41)) < 0.5, -(2**30), 5)  # no-peer slots around ties
    s[16] = -(2**30)
    want = np.asarray(jnp.argmax(jnp.asarray(s), axis=1))
    got = swap_pick(torch.from_numpy(s)).numpy()
    assert np.array_equal(got, want)


def test_birth_order_is_stable():
    """The first total_peers columns of a stable argsort: ties (small hash
    ranges and the INT32_MAX of ineligible slots) keep slot order."""
    rng = np.random.default_rng(4)
    rank = rng.integers(0, 6, size=(40, 40)).astype(np.int32)
    rank[rng.random((40, 40)) < 0.3] = 2**31 - 1
    rank[:4] = 2**31 - 1
    for k in (1, 4, 40):
        want = np.asarray(jnp.argsort(jnp.asarray(rank), axis=1)[:, :k])
        got = birth_order(torch.from_numpy(rank), k).numpy()
        assert np.array_equal(got, want), k
