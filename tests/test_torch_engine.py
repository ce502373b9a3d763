"""The port's flat message store against the JAX package's engine.

Handel sends through its own channel, so the engine's generic store
(`apply_emission`'s flat branch, `latency_arrivals`, the delivery view and
the clear) is driven here directly: the same emissions go into the same
Handel-built state on both sides, then one delivery tick runs, and every
leaf must agree.  The store holds 8 messages, so a 12-row emission also
exercises the full-store drop count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wittgenstein_tpu.engine import Emission as JEmission
from wittgenstein_tpu.engine import stack_states as jstack
from wittgenstein_tpu.protocols.handel import HandelParameters as JParams
from wittgenstein_tpu.protocols.handel_batched import make_handel as jmake
from wittgenstein_tpu_torch.engine import Emission as TEmission
from wittgenstein_tpu_torch.engine import replicate_state
from wittgenstein_tpu_torch.engine import stack_states as tstack
from wittgenstein_tpu_torch.interop import state_to_numpy
from wittgenstein_tpu_torch.protocols.handel import HandelParameters as TParams
from wittgenstein_tpu_torch.protocols.handel_batched import make_handel as tmake

K = 12


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


def _flat(jstate) -> dict:
    d = jax.tree_util.tree_map(np.asarray, jstate)._asdict()
    d["proto"] = dict(d["proto"])
    return d


def _assert_equal(jstate, tstate, tag):
    """Every leaf but the clock, which the port passes to its engine as
    an explicit host int (the JAX side reads it from `state.time`)."""
    want = _flat(jstate)
    got = state_to_numpy(tstate)
    for f, w in want.items():
        if f == "time":
            continue
        if f == "proto":
            for k in w:
                assert np.array_equal(w[k], got[f][k][0]), f"{tag}: proto.{k}"
        elif isinstance(w, np.ndarray):
            g = got[f][0]
            assert w.dtype == g.dtype and np.array_equal(w, g), f"{tag}: {f}"


def test_apply_emission_and_delivery_match():
    kw = dict(node_count=64, nodes_down=4, threshold=60)
    jnet, js = jmake(JParams(**kw), fuse_step=True, score_cache=False)
    tnet, ts = tmake(TParams(**kw), score_cache=False, device="cpu")
    ts = replicate_state(ts, 1, seeds=[0])
    rng = np.random.RandomState(3)
    # a static message type first, then per-row types into a partly full store
    for t, per_row_type in ((0, False), (5, True)):
        mask = rng.rand(K) < 0.9
        frm = rng.randint(0, 64, K).astype(np.int32)
        to = rng.randint(0, 64, K).astype(np.int32)
        mtype = rng.randint(0, 7, K).astype(np.int32) if per_row_type else 3
        jm = jnp.asarray(mtype) if per_row_type else mtype
        tm = torch.from_numpy(mtype)[None] if per_row_type else mtype
        js = js._replace(time=jnp.int32(t))
        js = jnet.apply_emission(
            js, JEmission(jnp.asarray(mask), jnp.asarray(frm), jnp.asarray(to), jm)
        )
        ts = tnet.apply_emission(
            ts,
            TEmission(torch.from_numpy(mask)[None], torch.from_numpy(frm),
                      torch.from_numpy(to)[None], tm),
            t,
        )
        _assert_equal(js, ts, f"emission at {t}")
    assert int(np.asarray(js.dropped)) > 0  # the full store dropped rows
    arrivals = np.asarray(js.ovf_arrival)[np.asarray(js.ovf_valid)]
    t_del = int(np.median(arrivals))  # deliver part of the store
    js, _ = jnet._deliver_and_clear(js._replace(time=jnp.int32(t_del)))
    ts, _ = tnet._deliver_and_clear(ts, t_del)
    _assert_equal(js, ts, f"delivery at {t_del}")
    assert int(np.asarray(js.msg_received).sum()) > 0


def test_stack_states_matches():
    """Independently built replicas (two node-layout seeds) stacked."""
    kw = dict(node_count=64, threshold=63)
    js = [jmake(JParams(**kw), seed=s, score_cache=False)[1] for s in (1, 2)]
    ts = [tmake(TParams(**kw), seed=s, score_cache=False, device="cpu")[1] for s in (1, 2)]
    want = _flat(jstack(js))
    got = state_to_numpy(tstack(ts))
    for f, w in want.items():
        if f == "proto":
            for k in w:
                assert np.array_equal(w[k], got[f][k]), f"proto.{k}"
        elif isinstance(w, np.ndarray):
            assert w.dtype == got[f].dtype and np.array_equal(w, got[f]), f


@pytest.mark.parametrize("m", [5, 3000])
def test_receiver_counters_spread_masked_rows(m):
    """The delivery's receiver counters (`add_masked`, both columns through
    one routed index) equal JAX's `.at[to].add(where(mask, vals, 0))` over
    a view whose unmasked rows all hold node 0, as a sparse store's empty
    slots do, and whose masked rows repeat destinations; more rows than
    trash cells wrap around."""
    from wittgenstein_tpu_torch.ops.indexing import TRASH_CELLS, add_masked

    rng = np.random.RandomState(m)
    r, n = 3, 17
    cols = [rng.randint(0, 50, size=(r, n)).astype(np.int32) for _ in range(2)]
    mask = rng.rand(r, m) < 0.1
    idx = np.where(mask, rng.randint(0, n, size=(r, m)), 0).astype(np.int32)
    vals = [mask.astype(np.int32), rng.randint(1, 60, size=(r, m)).astype(np.int32)]
    got = add_masked(tuple(torch.from_numpy(c) for c in cols), torch.from_numpy(idx),
                     tuple(torch.from_numpy(v) for v in vals), torch.from_numpy(mask))
    assert len(got) == 2
    for col, v, g in zip(cols, vals, got):
        g = g.numpy()
        for i in range(r):
            want = np.asarray(jnp.asarray(col[i]).at[idx[i]].add(np.where(mask[i], v[i], 0)))
            assert g.dtype == want.dtype and np.array_equal(g[i], want)
    assert (m > TRASH_CELLS) == (m == 3000)
