"""Batched CasperIMD in the port against the JAX package, leaf for leaf.

CasperIMD runs on the flat store with the consensus-jump loop: 8-s
slots, one block producer per slot, attester committees voting 4 s into
each slot, and the GHOST-like fork choice over a height-indexed block
table.  Both packages build the population from the same JavaRandom
stream (observer, node 1's Byzantine producer, honest producers,
attesters).  Here: the host roles and node columns at the defaults (83
nodes) and at 1024 attesters (1027 nodes, BASELINE config 4, whose run
stays on the card) under the three ported builder and latency pairs, two
replicas of the default "wf" producer and of the father-skipping "sf"
producer over 80 000 ms (ten slots), a handover from a JAX state at
40 000 ms, and the port's live-row fork choice (`_best`, `_reevaluate`)
against JAX's full-width one on random states.  The other producer
variants and latency models are in test_torch_casper_variants.py.
"""

from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wittgenstein_tpu.engine import replicate_state as jreplicate
from wittgenstein_tpu.protocols.casper import CasperParameters as JParams
from wittgenstein_tpu.protocols.casper_batched import make_casper as jmake
from wittgenstein_tpu_torch.core.registries import builder_name
from wittgenstein_tpu_torch.engine import replicate_state as treplicate
from wittgenstein_tpu_torch.interop import state_from_numpy, state_to_numpy
from wittgenstein_tpu_torch.ops.indexing import live_rows
from wittgenstein_tpu_torch.protocols.casper import CasperParameters as TParams
from wittgenstein_tpu_torch.protocols.casper import casper_roles
from wittgenstein_tpu_torch.protocols.casper_batched import make_casper as tmake

REPLICAS = 2
MAX_HEIGHTS = 16
SIM_MS = 80_000
ROLE_FIELDS = ("is_att", "is_bp", "att_ids", "att_cidx", "committee", "prod_ids")
# builder and latency pairs of BASELINE config 4's sweep
PAIRS = {
    "distance": {},
    "aws": dict(node_builder_name=builder_name("AWS", True, 0.0),
                network_latency_name="AwsRegionNetworkLatency"),
    "ic3": dict(network_latency_name="IC3NetworkLatency"),
}
SIZES = {"defaults": {}, "1027": dict(cycle_length=4, attesters_per_round=256)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def jax_numpy(state) -> dict:
    d = jax.tree_util.tree_map(np.asarray, state)._asdict()
    d["proto"] = dict(d["proto"])
    return d


def assert_same_state(want: dict, got: dict, tag: str) -> None:
    """Every leaf equal in name, dtype, shape and bits."""
    assert set(want) == set(got), tag
    for f, w in want.items():
        g = got[f]
        if f == "proto":
            assert set(w) == set(g), f"{tag}: proto keys"
            for k in w:
                assert w[k].dtype == g[k].dtype and w[k].shape == g[k].shape, f"{tag}: proto.{k}"
                assert np.array_equal(w[k], g[k]), f"{tag}: proto.{k} differs"
        elif isinstance(w, np.ndarray):
            assert w.dtype == g.dtype and w.shape == g.shape, f"{tag}: {f} dtype/shape"
            assert np.array_equal(w, g), f"{tag}: {f} differs"
        else:
            assert g == w == (), f"{tag}: side-car {f}"


@pytest.mark.parametrize("pair", list(PAIRS))
@pytest.mark.parametrize("size", list(SIZES))
def test_roles_columns_and_initial_state(size, pair):
    kw = {**SIZES[size], **PAIRS[pair]}
    mh = 12 if size == "1027" else MAX_HEIGHTS
    jnet, jstate = jmake(JParams(**kw), max_heights=mh)
    tnet, tstate = tmake(TParams(**kw), max_heights=mh, device="cpu")
    jp, tp = jnet.protocol, tnet.protocol
    nodes, roles = casper_roles(TParams(**kw))
    assert roles["n_nodes"] == len(nodes) == tp.n_nodes == jp.n_nodes
    assert roles["bp0"] == tp.bp0 == jp.bp0 == 1
    for f in ROLE_FIELDS:
        want = np.asarray(getattr(jp, f))
        got = np.asarray(roles[f])
        assert want.dtype == got.dtype and np.array_equal(want, got), f
    assert tnet.flat and jnet.flat
    assert tnet.overflow_capacity == jnet.overflow_capacity == (
        1 << 19 if size == "1027" else 1 << 14)
    want = jax_numpy(jreplicate(jstate, 1))
    got = state_to_numpy(treplicate(tstate, 1))
    assert_same_state(want, got, "initial state")
    assert (got["city_idx"] == -1).all()  # the batched path's columns, every model


@pytest.fixture(scope="module")
def wf_jax():
    """The JAX reference at the defaults, "wf", 2 replicas: its state at
    40 000 ms and at 80 000 ms."""
    jnet, jstate = jmake(JParams(), max_heights=MAX_HEIGHTS)
    half = jnet.run_ms_batched(jreplicate(jstate, REPLICAS), SIM_MS // 2)
    full = jnet.run_ms_batched(half, SIM_MS // 2)
    return jax_numpy(half), jax_numpy(full)


def _check_chain(got: dict, parents: list) -> None:
    """Replica 0's block table and traffic: the JAX package's seed-0 run."""
    p = got["proto"]
    assert p["blk_parent"][0, : len(parents)].tolist() == parents
    assert not p["blk_exists"][0, len(parents):].any()
    assert (p["head"].max(-1) == len(parents) - 1).all()
    assert (got["msg_received"].sum(-1) == 15687).all()
    assert (got["dropped"] == 0).all() and (got["time"] == SIM_MS).all()


def test_wf_run_matches(wf_jax):
    _, want = wf_jax
    tnet, tstate = tmake(TParams(), max_heights=MAX_HEIGHTS, device="cpu")
    got = state_to_numpy(tnet.run_ms_batched(treplicate(tstate, REPLICAS), SIM_MS))
    assert_same_state(want, got, f"after {SIM_MS} ms")
    _check_chain(got, list(range(-1, 9)))


def test_sf_run_matches():
    """The father-skipping producer forks the chain: its blocks stand on
    their grandfathers."""
    jnet, jstate = jmake(JParams(), max_heights=MAX_HEIGHTS, byz_variant="sf")
    tnet, tstate = tmake(TParams(), max_heights=MAX_HEIGHTS, byz_variant="sf", device="cpu")
    want = jax_numpy(jnet.run_ms_batched(jreplicate(jstate, REPLICAS), SIM_MS))
    got = state_to_numpy(tnet.run_ms_batched(treplicate(tstate, REPLICAS), SIM_MS))
    assert_same_state(want, got, f"after {SIM_MS} ms")
    _check_chain(got, [-1, 0, 1, 1, 2, 2, 4, 4, 6, 6])
    assert (got["proto"]["byz_direct"].sum(-1) > 0).all()


def test_interop_handover(wf_jax):
    """The JAX package runs 40 000 ms, the port takes its state over
    (timers and attestations waiting in the store) and runs 40 000 ms
    more, as the JAX package does."""
    half, full = wf_jax
    tnet, _ = tmake(TParams(), max_heights=MAX_HEIGHTS, device="cpu")
    ts = state_from_numpy(half, "cpu")
    assert_same_state(half, state_to_numpy(ts), "handover")
    assert (half["ovf_valid"].sum(-1) > 0).all()
    assert_same_state(full, state_to_numpy(tnet.run_ms_batched(ts, SIM_MS // 2)),
                      "after the handover")


def _random_proto(rng, r, n, mh, ma):
    """Random fork-choice states: a random block tree per replica (parent
    below the child), random inclusions, attestations, receptions,
    pending re-evaluations and heads."""
    parent = np.full((r, mh), -1)
    anc = np.zeros((r, mh, mh), bool)
    for i in range(r):
        for h in range(1, mh):
            parent[i, h] = rng.randint(0, h)
            anc[i, h] = anc[i, parent[i, h]]
            anc[i, h, parent[i, h]] = True
    return {
        "anc": anc,
        "blk_att": rng.rand(r, mh, ma) < 0.2,
        "blk_time": rng.randint(0, 4, size=(r, mh)).astype(np.int32),
        "att_exists": rng.rand(r, ma) < 0.7,
        "att_head": rng.randint(0, mh, size=(r, ma)).astype(np.int32),
        "rec_att": rng.rand(r, n, ma) < 0.3,
        "reeval": rng.rand(r, n, mh) < 0.3,
        "head": rng.randint(0, mh, size=(r, n)).astype(np.int32),
    }


State = namedtuple("State", "seed time")


@pytest.mark.parametrize("ties", [True, False], ids=["coin", "time_height"])
def test_live_row_fork_choice_matches_full(ties):
    """`_best` and `_reevaluate` over the live rows equal JAX's full-width
    forms on random states and masks (three replicas, one of them with
    no live row)."""
    r, t = 3, 12_345
    jnet, _ = jmake(JParams(random_on_ties=ties), max_heights=MAX_HEIGHTS)
    tnet, _ = tmake(TParams(random_on_ties=ties), max_heights=MAX_HEIGHTS, device="cpu")
    jp, tp = jnet.protocol, tnet.protocol
    n, mh, ma = tp.n_nodes, tp.mh, tp.ma
    rng = np.random.RandomState(3 if ties else 4)
    host = _random_proto(rng, r, n, mh, ma)
    seed = np.array([0, 7, 11], np.int32)
    o2 = rng.randint(0, mh, size=(r, n)).astype(np.int32)
    mask = rng.rand(r, n) < 0.4
    mask[2] = False
    js = State(jnp.asarray(seed), jnp.full(r, t, jnp.int32))
    jproto = {k: jnp.asarray(v) for k, v in host.items()}
    tproto = {k: torch.from_numpy(v) for k, v in host.items()}
    ctx = tp.fork_context(tproto)
    tseed = torch.from_numpy(seed)

    want = jax.vmap(lambda s, p, b, m: jp._best(s, p, p["rec_att"], p["head"], b, m))(
        js, jproto, jnp.asarray(o2), jnp.asarray(mask))
    (rows,) = live_rows([torch.from_numpy(mask)])
    got = tp._best(tproto, ctx, tproto["head"], torch.from_numpy(o2), rows, tseed, t)
    assert got.dtype == torch.int32 and np.array_equal(np.asarray(want), got.numpy())
    assert (got.numpy() != host["head"]).any()

    want = jax.vmap(lambda s, p, m: jp._reevaluate(s, p, m))(js, jproto, jnp.asarray(mask))
    got = tp._reevaluate(tproto, ctx, torch.from_numpy(mask), rows, tseed, t)
    for k in ("head", "reeval"):
        assert np.array_equal(np.asarray(want[k]), got[k].numpy()), k
    assert (got["head"].numpy() != host["head"]).any()
    # no row acting: the fold changes nothing
    (none,) = live_rows([torch.zeros(r, n, dtype=torch.bool)])
    assert none is None
    assert tp._reevaluate(tproto, ctx, torch.zeros(r, n, dtype=torch.bool), none, tseed,
                          t) is tproto
