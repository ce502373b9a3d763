"""Batched SanFerminSignature in the port against the JAX package, leaf
for leaf.

Both packages build SanFermin from the same parameters and seed: the
node population must come out equal at 64 and 4096 nodes, so must the
state `make_sanfermin` returns (its pre-applied first level, `pending`
and the initial requests in the store), and two replicas run through
`run_ms_batched` on the 512-row time wheel must hold identical state in
every leaf after every chunk — `done_at`, the traffic counters, the
wheel and overflow lanes with their payloads, `dropped`, and the whole
`proto` dict (`pending`'s uint32 words as int32 bit views; `agg` is an
int32 count here, not a word).  Every leaf is an integer or bool, so
every comparison is exact (tolerance 0).
"""

import jax
import numpy as np
import pytest
import torch

from wittgenstein_tpu.core.node import build_node_columns as jcolumns
from wittgenstein_tpu.engine import replicate_state as jreplicate
from wittgenstein_tpu.protocols.sanfermin import SanFerminSignature
from wittgenstein_tpu.protocols.sanfermin import SanFerminSignatureParameters as JParams
from wittgenstein_tpu.protocols.sanfermin_batched import make_sanfermin as jmake
from wittgenstein_tpu_torch.core.node import build_node_columns as tcolumns
from wittgenstein_tpu_torch.engine import replicate_state as treplicate
from wittgenstein_tpu_torch.interop import state_from_numpy, state_to_numpy
from wittgenstein_tpu_torch.protocols.sanfermin import SanFerminSignatureParameters as TParams
from wittgenstein_tpu_torch.protocols.sanfermin import sanfermin_population
from wittgenstein_tpu_torch.protocols.sanfermin_batched import make_sanfermin as tmake

REPLICAS = 2
CHUNK_MS = 500
N_CHUNKS = 3  # 1500 ms: past the first reply timeout (301 ms) and every node done


def _args(n, cc=1):
    """The form of the scenario main (sanfermin.py:339)."""
    return (n, n, 2, 48, 300, cc, False, None, None)


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


@pytest.mark.parametrize("n", [64, 4096])
def test_node_columns_match(n):
    want = jcolumns(SanFerminSignature(JParams(*_args(n))).network().all_nodes)
    got = tcolumns(sanfermin_population(TParams(*_args(n))))
    assert set(want) == set(got)
    for k in want:
        assert want[k].dtype == got[k].dtype and np.array_equal(want[k], got[k]), k


@pytest.mark.parametrize("n, capacity", [(64, 1 << 14), (4096, 1 << 16)])
def test_initial_state_matches(n, capacity):
    _, js = jmake(JParams(*_args(n)), capacity=capacity)
    tnet, ts = tmake(TParams(*_args(n)), capacity=capacity, device="cpu")
    assert tnet.wheel_rows == 512
    assert_same_state(jax_numpy(js), state_to_numpy(ts), f"{n} init")
    assert ts.proto["agg"].dtype == torch.int32
    assert state_to_numpy(ts)["proto"]["agg"].dtype == np.int32  # a count, not a word


@pytest.fixture(scope="module")
def runs():
    """Per candidate_count: the JAX reference's states after 0..N_CHUNKS
    chunks of 64 nodes x 2 replicas, built lazily."""
    cache = {}

    def get(cc):
        if cc not in cache:
            jnet, js = jmake(JParams(*_args(64, cc)))
            js = jreplicate(js, REPLICAS)
            snaps = [jax_numpy(js)]
            for _ in range(N_CHUNKS):
                js = jnet.run_ms_batched(js, CHUNK_MS)
                snaps.append(jax_numpy(js))
            cache[cc] = snaps
        return cache[cc]

    return get


@pytest.mark.parametrize("cc", [1, 2])
def test_run_matches(runs, cc):
    """Replicas 1.. keep replica 0's initial pending and sends (the JAX
    replicate_state's copy), then diverge by seed."""
    snaps = runs(cc)
    tnet, ts = tmake(TParams(*_args(64, cc)), device="cpu")
    ts = treplicate(ts, REPLICAS)
    assert_same_state(snaps[0], state_to_numpy(ts), f"cc={cc} replicated")
    for c in range(N_CHUNKS):
        ts = tnet.run_ms_batched(ts, CHUNK_MS)
        assert_same_state(snaps[c + 1], state_to_numpy(ts), f"cc={cc} {CHUNK_MS * (c + 1)} ms")
    p = snaps[-1]["proto"]
    assert p["done"].all() and (p["sent_req"] > 0).all()
    assert not np.array_equal(p["thr_at"][0], p["thr_at"][1])


def test_interop_handover(runs):
    snaps = runs(1)
    tnet, _ = tmake(TParams(*_args(64)), device="cpu")
    ts = state_from_numpy(snaps[1], "cpu")
    assert_same_state(snaps[1], state_to_numpy(ts), "handover")
    assert ts.proto["pending"].dtype == torch.int32
    ts = tnet.run_ms_batched(ts, 2 * CHUNK_MS)
    assert_same_state(snaps[3], state_to_numpy(ts), "handover + 1000 ms")


def test_dropping_run_matches():
    """A store too small for the traffic: 2048 nodes on a 64-slot wheel
    row with a 128-entry overflow lane (capacity 1 << 10) spill and drop
    within 400 ms, and the spill, the drops and everything else agree.
    (At 256 nodes the same capacity drops nothing in either package.)"""
    args = _args(2048)
    jnet, js = jmake(JParams(*args), capacity=1 << 10)
    tnet, ts = tmake(TParams(*args), capacity=1 << 10, device="cpu")
    js, ts = jreplicate(js, REPLICAS), treplicate(ts, REPLICAS)
    for c in range(2):
        js = jnet.run_ms_batched(js, 200)
        ts = tnet.run_ms_batched(ts, 200)
        assert_same_state(jax_numpy(js), state_to_numpy(ts), f"{200 * (c + 1)} ms")
    assert (np.asarray(js.dropped) > 0).all() and np.asarray(js.ovf_valid).any()
