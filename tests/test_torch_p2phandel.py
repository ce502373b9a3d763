"""Batched P2PHandel in the port against the JAX package, leaf for leaf.

Both packages build P2PHandel from the same parameters and seed: the
host graph (relay draw, nodes, setPeers) must come out equal, and two
replicas run through `run_ms_batched` on the engine's 512-row time wheel
must hold identical state in every leaf after every chunk — `done_at`,
the traffic counters, the wheel and overflow lanes with their payloads,
and the whole `proto` dict.  Every leaf is an integer or bool, so every
comparison is exact (tolerance 0).  The configurations are the JAX
package's test parameters (tests/test_p2phandel_batched.py make_params)
over both double-aggregate strategies, State broadcasts, the "all"
strategy and both score-cache arms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wittgenstein_tpu.engine import replicate_state as jreplicate
from wittgenstein_tpu.protocols.p2phandel import P2PHandelParameters as JParams
from wittgenstein_tpu.protocols.p2phandel_batched import make_p2phandel as jmake
from wittgenstein_tpu_torch.engine import replicate_state as treplicate
from wittgenstein_tpu_torch.interop import state_to_numpy
from wittgenstein_tpu_torch.protocols import p2phandel_batched as tp2p
from wittgenstein_tpu_torch.protocols.p2phandel import P2PHandelParameters as TParams
from wittgenstein_tpu_torch.protocols.p2phandel import p2phandel_population
from wittgenstein_tpu_torch.protocols.p2phandel_batched import make_p2phandel as tmake

SMALL = dict(
    signing_node_count=64, relaying_node_count=8, threshold=60, connection_count=12,
    pairing_time=20, sigs_send_period=200,
)
REPLICAS = 2
CHUNK_MS = 500
N_CHUNKS = 3
# name: (parameter overrides, score_cache)
CONFIGS = {
    "checksigs2": ({}, True),
    # checked against the checksigs2 reference minus ver_card, and against
    # the port's own cache arm
    "checksigs2_nocache": ({}, False),
    "checksigs1": (dict(double_aggregate_strategy=False), True),
    "send_state": (dict(send_state=True), True),
    "strategy_all": (dict(send_sigs_strategy="all"), False),
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
            assert set(w) == set(g), f"{tag}: proto keys {sorted(set(w) ^ set(g))}"
            for k in w:
                assert w[k].dtype == g[k].dtype, f"{tag}: proto.{k} dtype {g[k].dtype}"
                assert w[k].shape == g[k].shape, f"{tag}: proto.{k} shape {g[k].shape}"
                assert np.array_equal(w[k], g[k]), f"{tag}: proto.{k} differs"
        elif isinstance(w, np.ndarray):
            assert w.dtype == g.dtype and w.shape == g.shape, f"{tag}: {f} dtype/shape"
            assert np.array_equal(w, g), f"{tag}: {f} differs"
        else:
            assert g == w == (), f"{tag}: side-car {f}"


def _without_cache(snap: dict) -> dict:
    out = dict(snap)
    out["proto"] = {k: v for k, v in snap["proto"].items() if k != "ver_card"}
    return out


@pytest.fixture(scope="module")
def runs():
    """Per configuration: the JAX reference's states after 0..N_CHUNKS
    chunks, built lazily and shared by the tests below."""
    cache = {}

    def get(name):
        if name == "checksigs2_nocache":
            return [_without_cache(s) for s in get("checksigs2")]
        if name not in cache:
            kw, score_cache = CONFIGS[name]
            jnet, jstate = jmake(JParams(**SMALL, **kw), score_cache=score_cache)
            js = jreplicate(jstate, REPLICAS)
            snaps = [jax_numpy(js)]
            for _ in range(N_CHUNKS):
                js = jnet.run_ms_batched(js, CHUNK_MS)
                snaps.append(jax_numpy(js))
            cache[name] = snaps
        return cache[name]

    return get


@pytest.mark.parametrize("kw", [{}, SMALL], ids=["defaults", "small"])
def test_host_graph_matches(kw):
    """Adjacency, relay set and node columns equal the JAX package's,
    which builds them with its oracle P2PNetwork."""
    jnet, jstate = jmake(JParams(**kw))
    nodes, adj, just_relay = p2phandel_population(TParams(**kw))
    assert np.array_equal(np.asarray(jnet.protocol.adj), adj)
    assert np.array_equal(np.asarray(jnet.protocol.just_relay), just_relay)
    assert just_relay.sum() == TParams(**kw).relaying_node_count
    for col in ("x", "y"):
        assert np.array_equal(np.asarray(getattr(jstate, col)), [getattr(n, col) for n in nodes])
    if not kw:
        # the reference defaults: 120 nodes, 40 connections on average
        assert adj.shape == (120, 54) and (adj >= 0).sum() == 120 * 40


@pytest.mark.parametrize("name", list(CONFIGS))
def test_run_matches(runs, name):
    kw, score_cache = CONFIGS[name]
    snaps = runs(name)
    tnet, tstate = tmake(TParams(**SMALL, **kw), score_cache=score_cache, device="cpu")
    ts = treplicate(tstate, REPLICAS)
    assert_same_state(snaps[0], state_to_numpy(ts), f"{name} replicated")
    for c in range(N_CHUNKS):
        ts = tnet.run_ms_batched(ts, CHUNK_MS)
        assert_same_state(snaps[c + 1], state_to_numpy(ts), f"{name} {CHUNK_MS * (c + 1)} ms")
    # the run reached the aggregation and lost nothing
    assert (snaps[-1]["done_at"] > 0).all() and not snaps[-1]["dropped"].any()
    if name == "checksigs2_nocache":
        # the two score-cache arms agree on every other leaf
        cnet, cstate = tmake(TParams(**SMALL), score_cache=True, device="cpu")
        cs = cnet.run_ms_batched(treplicate(cstate, REPLICAS), CHUNK_MS * N_CHUNKS)
        assert_same_state(_without_cache(state_to_numpy(cs)), state_to_numpy(ts), "cache arms")


@pytest.mark.parametrize("n", [33, 64, 72, 120])
def test_pack_matches_jax(n):
    """The port's _pack (pack_bool_words) equals the JAX package's
    weighted-sum _pack, and _unpack inverts it."""
    rng = np.random.default_rng(n)
    bits = rng.random((3, 7, n)) < 0.5
    bits[0] = True  # bit 31 of every word set: the int32 sign bit
    jp = jax.tree_util.tree_map(
        np.asarray, jmake(JParams(**dict(SMALL, signing_node_count=n - 8)))[0].protocol._pack(
            jnp.asarray(bits)
        )
    )
    tproto = tmake(TParams(**dict(SMALL, signing_node_count=n - 8)), device="cpu")[0].protocol
    got = tproto._pack(torch.from_numpy(bits))
    assert got.dtype == torch.int32 and np.array_equal(jp, got.numpy())
    assert np.array_equal(tproto._unpack(got).numpy(), bits)


def test_pack_runs_through_pack_bool_words(monkeypatch):
    """_pack is the pack_bool_words form: once a tick for the verified
    rows, once more on a sendSigs beat for the diff."""
    shapes = []
    real = tp2p.pack_bool_words

    def spy(bits):
        shapes.append(tuple(bits.shape))
        return real(bits)

    monkeypatch.setattr(tp2p, "pack_bool_words", spy)
    net, state = tmake(TParams(**SMALL), device="cpu")
    n = net.protocol.n_nodes
    net.run_ms_batched(treplicate(state, REPLICAS), 3)  # ticks 0, 1 (a beat), 2
    assert shapes == [(REPLICAS, n, n)] * 4
