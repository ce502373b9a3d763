"""Batched Handel in the port against the JAX package, leaf for leaf.

Both packages build Handel at 64 nodes from the same parameters, run two
replicas through `run_ms_batched` in 100-ms chunks, and must hold
identical state in every leaf after every chunk: `done_at`, the traffic
counters, the message store and the whole `proto` dict (uint32 words in
JAX are int32 bit views in the port; `interop.state_to_numpy` gives them
back as uint32).  All leaves are integer or bool, so every comparison is
exact.  The JAX side runs as its own tests run it on the CPU (the lax
twins of its Pallas kernels, fuse_step=True); the port runs the plain
versions of its kernels.  The JAX reference runs once per configuration
(module-scoped fixtures) and the tests share it.
"""

import jax
import numpy as np
import pytest
import torch

from wittgenstein_tpu.engine import replicate_state as jreplicate
from wittgenstein_tpu.protocols.handel import HandelParameters as JParams
from wittgenstein_tpu.protocols.handel_batched import make_handel as jmake
from wittgenstein_tpu_torch.engine import replicate_state as treplicate
from wittgenstein_tpu_torch.interop import state_from_numpy, state_to_numpy
from wittgenstein_tpu_torch.protocols.handel import HandelParameters as TParams
from wittgenstein_tpu_torch.protocols.handel_batched import make_handel as tmake

CHUNK_MS = 100
CACHE_LEAVES = ("cand_s", "cand_card", "cand_wind", "cand_aggi")
N_CHUNKS = 3
REPLICAS = 2

CONFIGS = {
    "flagship_cache": (dict(node_count=64, threshold=63), True),
    # checked against the flagship_cache reference minus its four cache
    # leaves: the JAX package pins its two arms equal on every other leaf
    # (tests/test_score_cache.py), and sharing saves a reference compile
    "flagship_nocache": (dict(node_count=64, threshold=63), False),
    "byzantine_suicide": (
        dict(node_count=64, nodes_down=16, threshold=47, byzantine_suicide=True), True
    ),
    "hidden_byzantine": (
        dict(node_count=64, nodes_down=16, threshold=47, hidden_byzantine=True), False
    ),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path runs many small ops: one intra-op thread is
    faster than a pool (about 1.8x at 64 nodes) and does not contend with
    the test workers running beside it."""
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


def _build(name, jax_side=True):
    kw, cache = CONFIGS[name]
    jnet, jstate = (
        jmake(JParams(**kw), fuse_step=True, score_cache=cache) if jax_side else (None, None)
    )
    tnet, tstate = tmake(TParams(**kw), score_cache=cache, device="cpu")
    return jnet, jstate, tnet, tstate


def _without_caches(snap: dict) -> dict:
    out = dict(snap)
    out["proto"] = {k: v for k, v in snap["proto"].items() if k not in CACHE_LEAVES}
    return out


@pytest.fixture(scope="module")
def runs():
    """Per configuration: the JAX reference's states after 0..N_CHUNKS
    chunks, built lazily and shared by the tests below."""
    cache = {}

    def get(name):
        if name == "flagship_nocache":
            jnet, js, _, _, snaps = get("flagship_cache")
            _, _, tnet, tstate = _build(name, jax_side=False)
            return jnet, js, tnet, tstate, [_without_caches(s) for s in snaps]
        if name not in cache:
            jnet, jstate, tnet, tstate = _build(name)
            js = jreplicate(jstate, REPLICAS)
            snaps = [jax_numpy(js)]
            for _ in range(N_CHUNKS):
                js = jnet.run_ms_batched(js, CHUNK_MS)
                snaps.append(jax_numpy(js))
            cache[name] = (jnet, js, tnet, tstate, snaps)
        return cache[name]

    return get


@pytest.mark.parametrize("name", ["flagship_cache", "byzantine_suicide"])
def test_initial_state_matches(name):
    _, jstate, _, tstate = _build(name)
    assert_same_state(jax_numpy(jstate), state_to_numpy(tstate), f"{name} init")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_run_matches(runs, name):
    _, _, tnet, tstate, snaps = runs(name)
    ts = treplicate(tstate, REPLICAS)
    assert_same_state(snaps[0], state_to_numpy(ts), f"{name} replicated")
    for c in range(N_CHUNKS):
        ts = tnet.run_ms_batched(ts, CHUNK_MS)
        assert_same_state(snaps[c + 1], state_to_numpy(ts), f"{name} {CHUNK_MS * (c + 1)} ms")
    if name == "flagship_cache":
        # the run reached the aggregation: leaves compared above are live
        assert (snaps[-1]["done_at"] > 0).any()


def test_stop_when_done_stops_on_the_same_tick(runs):
    """From the 300-ms states, run on with stop_when_done: all 64 nodes
    finish inside the window, so the loop stops mid-chunk, and both
    packages must stop on the same tick (post-done ticks would move
    the dissemination counters and send_ctr)."""
    jnet, js, tnet, _, snaps = runs("flagship_cache")
    ts = state_from_numpy(snaps[-1], "cpu")
    for _ in range(2):
        js = jnet.run_ms_batched(js, CHUNK_MS, True)
        ts = tnet.run_ms_batched(ts, CHUNK_MS, True)
        assert_same_state(jax_numpy(js), state_to_numpy(ts), "stop_when_done")
    done = state_to_numpy(ts)["done_at"]
    assert (done > 0).all() and done.max() < 300 + 2 * CHUNK_MS - 1


def test_interop_handover(runs):
    """JAX runs 100 ms, the state crosses into the port, both run 100 ms
    more and agree; the crossing itself is lossless both ways."""
    _, _, tnet, _, snaps = runs("flagship_cache")
    ts = state_from_numpy(snaps[1], "cpu")
    assert_same_state(snaps[1], state_to_numpy(ts), "handover")
    assert ts.proto["inc"].dtype == torch.int32  # uint32 words as bit views
    ts = tnet.run_ms_batched(ts, CHUNK_MS)
    assert_same_state(snaps[2], state_to_numpy(ts), "handover + 100 ms")


def test_ungated_stop_when_done_stops_each_replica(runs):
    """run_ms with stop_when_done (the JAX package's vmapped
    _run_ms_impl): each replica stops on its own done tick and freezes
    there while the other steps on."""
    jnet, js, tnet, _, snaps = runs("flagship_cache")
    run = jax.jit(jax.vmap(lambda s: jnet._run_ms_impl(s, CHUNK_MS, True)))
    want = jax_numpy(run(js))
    got = tnet.run_ms(state_from_numpy(snaps[-1], "cpu"), CHUNK_MS, True)
    assert_same_state(want, state_to_numpy(got), "run_ms stop_when_done")
    last = want["done_at"].max(axis=1)
    assert last[0] != last[1]  # the replicas finished on different ticks


def test_same_tick_selection_lever_matches():
    """boundary_view=False: the JAX package's pre-boundary-view selection
    (an ablation lever, not parity-correct) is ported too."""
    kw = dict(node_count=64, threshold=63)
    jnet, jstate = jmake(JParams(**kw), fuse_step=True, score_cache=True, boundary_view=False)
    tnet, tstate = tmake(TParams(**kw), score_cache=True, boundary_view=False, device="cpu")
    js = jnet.run_ms_batched(jreplicate(jstate, REPLICAS), CHUNK_MS)
    ts = tnet.run_ms_batched(treplicate(tstate, REPLICAS), CHUNK_MS)
    assert_same_state(jax_numpy(js), state_to_numpy(ts), "boundary_view=False")


def test_ungated_run_ms_matches():
    """Desynchronized starts cover every beat residue, so run_ms_batched
    takes the ungated path (tick_beat every tick, the JAX package's
    vmapped _run_ms_impl)."""
    kw = dict(node_count=64, threshold=63, desynchronized_start=40)
    jnet, jstate = jmake(JParams(**kw), fuse_step=True, score_cache=False)
    tnet, tstate = tmake(TParams(**kw), score_cache=False, device="cpu")
    assert len(tnet.protocol.BEAT_RESIDUES) >= tnet.protocol.BEAT_PERIOD
    js = jnet.run_ms_batched(jreplicate(jstate, REPLICAS), 60)
    ts = tnet.run_ms_batched(treplicate(tstate, REPLICAS), 60)
    assert_same_state(jax_numpy(js), state_to_numpy(ts), "ungated")
    # step() is one ungated tick plus the clock
    assert_same_state(
        state_to_numpy(tnet.run_ms(ts, 1)), state_to_numpy(tnet.step(ts)), "step"
    )


def test_wheel_store_matches():
    """Handel on the 512-row time wheel: the per-ms beat-gated loop visits
    one wheel row per tick (the channel bypasses the generic store, so the
    rows stay empty and the clear must keep them so), leaf for leaf with
    the JAX package (tests/test_timewheel.py's wheel case)."""
    kw = dict(node_count=64, threshold=63)
    jnet, js = jmake(JParams(**kw), fuse_step=True, score_cache=True, wheel_rows=512)
    tnet, ts = tmake(TParams(**kw), score_cache=True, wheel_rows=512, device="cpu")
    assert not tnet.flat and tnet.wheel_rows == 512
    js = jnet.run_ms_batched(jreplicate(js, REPLICAS), 300)
    ts = tnet.run_ms_batched(treplicate(ts, REPLICAS), 300)
    assert_same_state(jax_numpy(js), state_to_numpy(ts), "wheel store")
    assert ts.msg_valid.shape == (REPLICAS, 512, 64)
    assert (ts.done_at > 0).any()
