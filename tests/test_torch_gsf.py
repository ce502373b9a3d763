"""Batched GSFSignature in the port against the JAX package, leaf for leaf.

Both packages build GSF from the same parameters and seed, run the same
replicas through `run_ms_batched` (beat-gated, `stop_when_done`) in
chunks, and must hold identical state in every leaf after every chunk:
`done_at`, the traffic counters, the message store and the whole `proto`
dict (uint32 words in JAX are int32 bit views in the port;
`interop.state_to_numpy` gives them back as uint32).  Every leaf is an
integer or bool, so every comparison is exact (tolerance 0).  The JAX
side runs as its own tests run it on the CPU (the lax twins of its Pallas
kernels); the port runs the plain versions of its kernels.  The JAX
reference runs once per configuration (a module-scoped fixture) and the
tests share it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wittgenstein_tpu.engine import replicate_state as jreplicate
from wittgenstein_tpu.protocols.gsf import GSFSignatureParameters as JParams
from wittgenstein_tpu.protocols.gsf_batched import BatchedGSF as JGSF
from wittgenstein_tpu.protocols.gsf_batched import make_gsf as jmake
from wittgenstein_tpu_torch.engine import replicate_state as treplicate
from wittgenstein_tpu_torch.interop import state_from_numpy, state_to_numpy
from wittgenstein_tpu_torch.protocols import gsf_batched as tgsf
from wittgenstein_tpu_torch.protocols.gsf import GSFSignatureParameters as TParams
from wittgenstein_tpu_torch.protocols.gsf_batched import BatchedGSF as TGSF
from wittgenstein_tpu_torch.protocols.gsf_batched import make_gsf as tmake

# the JAX package's registry config (core/registries.py _make_gsf_small)
SMALL = dict(
    node_count=64, threshold=int(64 * 0.99), pairing_time=3, timeout_per_level_ms=50,
    period_duration_ms=10, accelerated_calls_count=10, nodes_down=0,
)
# name: (parameters, replicas, chunk ms, chunks); stop_when_done throughout
CONFIGS = {
    "small": (SMALL, 2, 100, 4),
    "nodes_down": (dict(SMALL, nodes_down=16, threshold=40), 2, 200, 3),
    "no_bursts": (dict(SMALL, accelerated_calls_count=0), 2, 200, 3),
    # the 2-, 4- and 8-word buckets
    "n256": (dict(node_count=256, threshold=253), 1, 100, 2),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small ops: one intra-op thread is faster than a pool and does
    not contend with the test workers running beside it."""
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


@pytest.fixture(scope="module")
def runs():
    """Per configuration: the JAX reference's states after 0..chunks
    chunks, built lazily and shared by the tests below."""
    cache = {}

    def get(name):
        if name not in cache:
            kw, replicas, chunk, n_chunks = CONFIGS[name]
            jnet, jstate = jmake(JParams(**kw))
            js = jreplicate(jstate, replicas)
            snaps = [jax_numpy(js)]
            for _ in range(n_chunks):
                js = jnet.run_ms_batched(js, chunk, True)
                snaps.append(jax_numpy(js))
            cache[name] = (jnet, jstate, snaps)
        return cache[name]

    return get


def test_initial_state_matches(runs):
    _, jstate, _ = runs("small")
    _, tstate = tmake(TParams(**SMALL), device="cpu")
    assert_same_state(jax_numpy(jstate), state_to_numpy(tstate), "init")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_run_matches(runs, name):
    kw, replicas, chunk, n_chunks = CONFIGS[name]
    _, _, snaps = runs(name)
    tnet, tstate = tmake(TParams(**kw), device="cpu")
    ts = treplicate(tstate, replicas)
    assert_same_state(snaps[0], state_to_numpy(ts), f"{name} replicated")
    for c in range(n_chunks):
        ts = tnet.run_ms_batched(ts, chunk, True)
        assert_same_state(snaps[c + 1], state_to_numpy(ts), f"{name} {chunk * (c + 1)} ms")
    done, down = snaps[-1]["done_at"], snaps[-1]["down"]
    if name != "n256":
        # the run reached the aggregation: every live node, and no down one
        assert (done[~down] > 0).all() and (done[down] == 0).all()
    if name == "nodes_down":
        assert down.sum(axis=1).tolist() == [16, 16] and not down[:, 1].any()
    if name == "no_bursts":
        assert tnet.protocol.params.accelerated_calls_count == 0


def test_interop_handover(runs):
    """JAX runs 200 ms, the state crosses into the port, the port runs
    the last 200 ms and ends where JAX did; the crossing is lossless."""
    kw, _, chunk, n_chunks = CONFIGS["small"]
    _, _, snaps = runs("small")
    tnet, _ = tmake(TParams(**kw), device="cpu")
    ts = state_from_numpy(snaps[2], "cpu")
    assert_same_state(snaps[2], state_to_numpy(ts), "handover")
    assert ts.proto["ver"].dtype == torch.int32  # uint32 words as bit views
    for c in range(2, n_chunks):
        ts = tnet.run_ms_batched(ts, chunk, True)
        assert_same_state(snaps[c + 1], state_to_numpy(ts), f"handover + {chunk * (c - 1)} ms")


def _words(rng, shape, density):
    bits = rng.random(shape + (32,)) < density
    return (bits * (1 << np.arange(32, dtype=np.uint64))).sum(-1).astype(np.uint32)


@pytest.mark.parametrize("w", [1, 2, 4, 8])
def test_eval_sig_matches_jax(w):
    """The port's fused score (cand_score + popcount of the verified row)
    equals the JAX package's evaluateSig composition on random words,
    with empty verified rows, single-bit sigs and full blocks among them."""
    rng = np.random.default_rng(w)
    nl, k = 3, 10
    lv = np.arange(1, nl + 1, dtype=np.int32)
    bs = np.full(nl, 32 * w, dtype=np.int32)  # one full block of w words
    for density in (0.0, 0.02, 0.3, 0.9, 1.0):
        sig = _words(rng, (4, 5, nl, k, w), density)
        vb = _words(rng, (4, 5, nl, w), density)
        ib = _words(rng, (4, 5, nl, w), 0.1)
        vb[0] = 0  # empty verified rows take the |sig| branch
        single = np.zeros((4, 5, nl, k, w), np.uint32)
        single[..., 0] = np.uint32(1) << rng.integers(0, 32, (4, 5, nl, k)).astype(np.uint32)
        sig[1] = single[1]  # single-bit sigs: the individual fallback
        sig[2, :, :, 0] = 0xFFFFFFFF  # complete blocks: the completion bonus
        want = JGSF._eval_sig(
            None, jnp.asarray(sig), jnp.asarray(vb)[..., None, :], jnp.asarray(ib)[..., None, :],
            jnp.asarray(bs)[:, None], jnp.asarray(lv)[:, None],
        )
        got, card = TGSF._eval_sig(
            *(torch.from_numpy(a.view(np.int32)) for a in (sig, vb, ib)),
            torch.from_numpy(bs)[:, None], torch.from_numpy(lv)[:, None],
        )
        assert got.dtype == torch.int32
        assert np.array_equal(np.asarray(want), got.numpy()), f"w={w} density={density}"
        bits = np.unpackbits(sig.view(np.uint8), axis=-1).reshape(sig.shape[:-1] + (-1,))
        assert np.array_equal(bits.sum(-1), card.numpy())


def test_score_sites_run_through_cand_score(monkeypatch):
    """Every evaluateSig site calls the fused candidate score — the
    delivery merge (K + 2 = 10 rows), the selection's candidates (K = 8)
    and its one-hot individual (a K axis of 1) — and the a & ~b and
    a & b popcounts of _commit call popcount_binop."""
    seen, ops = [], []
    real_score, real_binop = tgsf.cand_score, tgsf.popcount_binop

    def score_spy(sig, inc, ind, agg=None):
        assert agg is ind  # agg = the individuals row: aggi = [sig ∩ ind ≠ ∅]
        seen.append(sig.shape[-2])
        return real_score(sig, inc, ind, agg)

    def binop_spy(a, b, op):
        ops.append(op)
        return real_binop(a, b, op)

    monkeypatch.setattr(tgsf, "cand_score", score_spy)
    monkeypatch.setattr(tgsf, "popcount_binop", binop_spy)
    net, state = tmake(TParams(**SMALL), device="cpu")
    net.run_ms_batched(treplicate(state, 1), 3)
    buckets = len(net.protocol.buckets)
    assert sorted(set(seen)) == [1, 8, 10]
    assert len(seen) == 3 * 3 * buckets  # three sites a bucket, three ticks
    assert ops.count("andnot") == 3 and ops.count("and") == 3 * buckets
