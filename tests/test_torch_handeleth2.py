"""Batched HandelEth2 in the port against the JAX package, leaf for leaf.

Both packages build HandelEth2 from the same parameters and seed: the
host roles (reception ranks, per-level emission peers, pairing times,
start offsets, down nodes) must come out equal, and replicas run through
`run_ms_batched` (beat-gated, or ungated where the beat residues cover
the period) or `run_ms` must hold identical state in every leaf — the
wheel and overflow lanes with their payloads, the traffic counters and
the whole `proto` dict, its uint32 words as int32 bit views
(`interop.state_to_numpy` gives them back as uint32).  Every leaf is an
integer or bool, so every comparison is exact (tolerance 0).  The
fused popcount sites, the unsigned word max and a spy on the kernel
forms are checked on random words.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wittgenstein_tpu.engine import replicate_state as jreplicate
from wittgenstein_tpu.ops.bitops import popcount_words as jp_popcount
from wittgenstein_tpu.protocols.handeleth2 import HandelEth2Parameters as JParams
from wittgenstein_tpu.protocols.handeleth2_batched import make_handeleth2 as jmake
from wittgenstein_tpu_torch.engine import replicate_state as treplicate
from wittgenstein_tpu_torch.interop import state_from_numpy, state_to_numpy
from wittgenstein_tpu_torch.protocols import handeleth2_batched as teth2
from wittgenstein_tpu_torch.protocols.handeleth2 import HandelEth2Parameters as TParams
from wittgenstein_tpu_torch.protocols.handeleth2 import handeleth2_roles
from wittgenstein_tpu_torch.protocols.handeleth2_batched import make_handeleth2 as tmake

REPLICAS = 2


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


def _pair(**kw):
    jnet, js = jmake(JParams(**kw))
    tnet, ts = tmake(TParams(**kw), device="cpu")
    return jnet, js, tnet, ts


@pytest.mark.parametrize("kw", [
    {},
    dict(node_count=32, nodes_down=3, desynchronized_start=30),
], ids=["defaults", "down_desync"])
def test_host_roles_match(kw):
    """HandelEth2.init's replay: the roles make_handeleth2 bakes, the
    node columns and the down set, equal to the JAX package's."""
    jnet, js = jmake(JParams(**kw))
    nodes, roles = handeleth2_roles(TParams(**kw))
    jp = jnet.protocol
    for name, want in (("reception_ranks", jp.rr), ("peers", jp.peers),
                       ("pairing", jp.pairing), ("delta", jp.delta)):
        want = np.asarray(want)
        assert roles[name].dtype == want.dtype and np.array_equal(roles[name], want), name
    assert np.array_equal(roles["down"], np.asarray(js.down))
    assert np.array_equal([nd.x for nd in nodes], np.asarray(js.x))
    assert np.array_equal([nd.y for nd in nodes], np.asarray(js.y))
    if kw:
        assert roles["down"].sum() == 3 and len(set(roles["delta"].tolist())) > 1
        assert (roles["peers"][roles["down"]] == -1).all()
    _, ts = tmake(TParams(**kw), device="cpu")
    assert_same_state(jax_numpy(js), state_to_numpy(ts), "init")


@pytest.fixture(scope="module")
def gated32():
    """32 nodes x 2 replicas on the beat-gated path: the JAX states at 0,
    300 and 700 ms, run in 100-ms chunks (one JAX program)."""
    jnet, js, tnet, ts = _pair(node_count=32)
    js = jreplicate(js, REPLICAS)
    snaps = [jax_numpy(js)]
    for chunks in (3, 4):
        for _ in range(chunks):
            js = jnet.run_ms_batched(js, 100)
        snaps.append(jax_numpy(js))
    return tnet, ts, snaps


def test_gated_run_matches(gated32):
    tnet, ts, snaps = gated32
    assert tnet.protocol.BEAT_PERIOD == 50 and tnet.protocol.BEAT_RESIDUES == (1,)
    ts = treplicate(ts, REPLICAS)
    assert_same_state(snaps[0], state_to_numpy(ts), "replicated")
    ts = tnet.run_ms_batched(ts, 300)
    assert_same_state(snaps[1], state_to_numpy(ts), "300 ms")
    ts = tnet.run_ms_batched(ts, 400)
    assert_same_state(snaps[2], state_to_numpy(ts), "700 ms")
    # the run verified, committed and completed levels: the leaves are live
    assert snaps[2]["proto"]["window"].max() == 128
    assert snaps[2]["msg_received"].sum() > 0


def test_interop_handover(gated32):
    """The JAX state at 300 ms crosses into the port losslessly, and both
    agree at 700 ms."""
    tnet, _, snaps = gated32
    ts = state_from_numpy(snaps[1], "cpu")
    assert_same_state(snaps[1], state_to_numpy(ts), "handover")
    assert ts.proto["c_atts"].dtype == torch.int32  # uint32 words as bit views
    ts = tnet.run_ms_batched(ts, 400)
    assert_same_state(snaps[2], state_to_numpy(ts), "handover + 400 ms")


def test_ungated_run_ms_matches():
    """16 nodes, one replica, the JAX package's run_ms (every tick runs
    tick_beat) against the port's run_ms."""
    jnet, js, tnet, ts = _pair(node_count=16)
    js = jnet.run_ms(js, 400)
    ts = tnet.run_ms(treplicate(ts, 1), 400)
    assert_same_state(jax_numpy(jreplicate(js, 1)), state_to_numpy(ts), "run_ms")


@pytest.mark.parametrize("kw, gated", [
    # 7 does not divide PERIOD_TIME: no beat structure
    (dict(node_count=32, period_duration_ms=7), False),
    # residues (1 + delta) % 4 cover the period: the ungated fallback
    (dict(node_count=32, period_duration_ms=4, desynchronized_start=20), False),
    (dict(node_count=32, nodes_down=4), True),
], ids=["period7", "period4_desync", "down4"])
def test_variants_match(kw, gated):
    jnet, js, tnet, ts = _pair(**kw)
    jp, tp = jnet.protocol, tnet.protocol
    assert tp.BEAT_PERIOD == jp.BEAT_PERIOD and tp.BEAT_RESIDUES == jp.BEAT_RESIDUES
    if kw.get("period_duration_ms") == 4:
        assert tp.BEAT_RESIDUES == (0, 1, 2, 3)
    assert gated == bool(tp.BEAT_PERIOD and len(tp.BEAT_RESIDUES) < tp.BEAT_PERIOD)
    js = jnet.run_ms_batched(jreplicate(js, REPLICAS), 500)
    ts = tnet.run_ms_batched(treplicate(ts, REPLICAS), 500)
    assert_same_state(jax_numpy(js), state_to_numpy(ts), str(kw))


LATE_CHUNK = 110


@pytest.fixture(scope="module")
def pair16():
    """The 16-node pair whose JAX side runs one program, LATE_CHUNK ms."""
    return _pair(node_count=16)


@pytest.fixture(scope="module")
def late16(pair16):
    """16 nodes x 2 replicas: the JAX states at 17930 ms and 18040 ms,
    across the stop branch of _start_stop (first at 18001 ms)."""
    jnet, js, tnet, _ = pair16
    js = jreplicate(js, REPLICAS)
    for _ in range(17930 // LATE_CHUNK):
        js = jnet.run_ms_batched(js, LATE_CHUNK)
    before = jax_numpy(js)
    after = jax_numpy(jnet.run_ms_batched(js, LATE_CHUNK))
    return tnet, before, after


def test_stop_branch_handover_matches(late16):
    """Process slots are reused: height 1001's slot stops and 1004 starts
    in it, adding to agg_done and contrib_total."""
    tnet, before, after = late16
    ts = state_from_numpy(before, "cpu")
    ts = tnet.run_ms_batched(ts, LATE_CHUNK)
    assert_same_state(after, state_to_numpy(ts), "18040 ms")
    assert set(np.unique(before["proto"]["height"]).tolist()) == {1001, 1002, 1003}
    p = after["proto"]
    assert set(np.unique(p["height"]).tolist()) == {1002, 1003, 1004}
    assert p["agg_done"].sum() == 32 and p["contrib_total"].sum() == 512
    assert after["dropped"].sum() == 0


def _rand_words(rng, shape, density):
    """uint32 words with each bit set with probability `density`, and bit
    31 among them."""
    bits = rng.random(shape + (32,)) < density
    return (bits * (np.uint64(1) << np.arange(32, dtype=np.uint64))).sum(-1).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("nw", [1, 2, 8])
def test_size_if_merged_matches_jax(nw):
    """The fused sizeIfMerged counts against the JAX package's
    _size_if_merged on random words: empty, sparse, dense and equal rows."""
    rng = np.random.default_rng(nw)
    lead, k = (2, 3, 3, 4), 8
    inc = _rand_words(rng, lead + (teth2.H, nw), 0.1)
    ind = inc & _rand_words(rng, lead + (teth2.H, nw), 0.7)
    cand = _rand_words(rng, lead + (k, teth2.H, nw), 0.05)
    inc[0, 0] = 0
    cand[0, 1, :, :2] = 0
    cand[1, 2, :, :, 3] = inc[1, 2]  # a candidate equal to the node rows
    jnet, _ = jmake(JParams(node_count=16))
    want = np.asarray(jnet.protocol._size_if_merged(
        jnp.asarray(inc)[..., None, :, :], jnp.asarray(ind)[..., None, :, :], jnp.asarray(cand)
    ))
    tp = teth2.BatchedHandelEth2(TParams(node_count=16), handeleth2_roles(
        TParams(node_count=16))[1], device="cpu")
    got, our_c = tp._size_if_merged(_t(inc), _t(ind), _t(cand))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert np.array_equal(our_c.numpy(), np.asarray(jax.lax.population_count(
        jnp.asarray(inc)).sum(-1), np.int32))


def test_commit_merge_matches_jax():
    """_commit's merge (merge_incoming per hash, and the individual bit
    .at[n, v_hash].max) against the JAX package's composition, on random
    words where the unsigned max drops bits: bit 31 among them."""
    rng = np.random.default_rng(7)
    r, n, nw = 2, 16, 2
    inc = _rand_words(rng, (r, n, teth2.H, nw), 0.2)
    ind = inc & _rand_words(rng, (r, n, teth2.H, nw), 0.5)
    cand = _rand_words(rng, (r, n, teth2.H, nw), 0.1)
    cand[0, :4] = 0
    v_hash = rng.integers(0, teth2.H, (r, n)).astype(np.int32)
    v_from = rng.integers(0, 32 * nw, (r, n)).astype(np.int32)
    v_from[:, :3] = [31, 63, 0]
    def jax_merge(inc_l, ind_l, cand_, vh, vf):  # handeleth2_batched.py:584-605
        pc = jp_popcount
        our_c, av_c, inter = pc(inc_l), pc(cand_), pc(inc_l & cand_) > 0
        merged_ind = ind_l | cand_
        use_cand = (our_c == 0) | (~inter)
        grow = pc(merged_ind) > our_c
        new_inc = jnp.where((av_c > 0)[..., None], jnp.where(
            use_cand[..., None], inc_l | cand_,
            jnp.where(grow[..., None], merged_ind, inc_l)), inc_l)
        nn = inc_l.shape[0]
        onehot = jnp.where(jnp.arange(nw) == (vf // 32)[:, None],
                           (jnp.uint32(1) << (vf % 32).astype(jnp.uint32))[:, None],
                           jnp.uint32(0))
        new_ind = ind_l.at[jnp.arange(nn), vh].max(onehot)
        return new_inc, new_ind

    tp = teth2.BatchedHandelEth2(TParams(node_count=64), handeleth2_roles(
        TParams(node_count=64))[1], device="cpu")
    assert tp.nw == nw
    got_inc, got_ind = tp._merge(_t(inc), _t(ind), _t(cand), torch.from_numpy(v_hash),
                                 torch.from_numpy(v_from))
    for i in range(r):
        w_inc, w_ind = jax_merge(*(jnp.asarray(a[i]) for a in (inc, ind, cand, v_hash, v_from)))
        assert np.array_equal(got_inc[i].numpy().view(np.uint32), np.asarray(w_inc))
        assert np.array_equal(got_ind[i].numpy().view(np.uint32), np.asarray(w_ind))


def test_unsigned_scatter_max_matches_jax():
    """fin_peers.at[w_to, slot].max(onehot) (handeleth2_batched.py:431):
    repeated destinations keep the largest word as uint32 — bit 31 is the
    largest, and a max, not an OR, drops the smaller bits."""
    rng = np.random.default_rng(3)
    rows, w, q = 6, 2, 40
    base = _rand_words(rng, (rows, w), 0.3)
    base[0, 0] = 0x80000000
    dest = rng.integers(0, rows + 1, q)  # rows = dropped
    dest[:6] = [1, 1, 1, 2, 2, rows]
    ids = rng.integers(0, 32 * w, q)
    ids[:6] = [31, 3, 63, 0, 31, 31]
    onehot = np.zeros((q, w), np.uint32)
    onehot[np.arange(q), ids // 32] = np.uint32(1) << (ids % 32).astype(np.uint32)
    want = np.asarray(jnp.asarray(base).at[jnp.asarray(dest)].max(
        jnp.asarray(onehot), mode="drop"))
    got = teth2._scatter_umax(_t(base), torch.from_numpy(dest), _t(onehot))
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert want[1, 0] == 0x80000000  # the bit-31 word won over 1 << 3
    a, b = _rand_words(rng, (50,), 0.5), _rand_words(rng, (50,), 0.5)
    got = teth2._umax(_t(a), _t(b))
    assert np.array_equal(got.numpy().view(np.uint32), np.maximum(a, b))


def test_popcount_sites_call_their_forms(monkeypatch, pair16):
    """Each popcount site of the port's HandelEth2 reaches a kernel form:
    `_select`'s score popcount_words and popcount_binop "and"/"or" with
    the node rows broadcast over K (never formed), `_commit`'s merge
    popcount_binop "and"/"or", `_card` popcount_words over (H, W) rows —
    and the run stays equal to the JAX package's."""
    calls = []
    for name in ("popcount_words", "popcount_binop"):
        real = getattr(teth2, name)

        def spy(*a, _name=name, _real=real, **kw):
            calls.append((_name, a[2] if _name == "popcount_binop" else None, a[0].shape))
            return _real(*a, **kw)

        monkeypatch.setattr(teth2, name, spy)
    jnet, js, tnet, ts = pair16
    js = jnet.run_ms_batched(jreplicate(js, REPLICAS), LATE_CHUNK)
    ts = tnet.run_ms_batched(treplicate(ts, REPLICAS), LATE_CHUNK)
    assert_same_state(jax_numpy(js), state_to_numpy(ts), "spied")
    k, nl, nw = 8, 5, 1
    ops = {(nm, op) for nm, op, _ in calls}
    assert ("popcount_binop", "and") in ops and ("popcount_binop", "or") in ops
    # _card: rows of H * nw words over [R, N, P, L]
    assert ("popcount_words", None, (REPLICAS, 16, 3, nl, teth2.H * nw)) in calls
    # the score: the candidates [R, N, P, L, K, H, nw] against the node rows
    # as a stride-0 view over K
    for op in ("and", "or"):
        assert ("popcount_binop", op, (REPLICAS, 16, 3, nl, 1, teth2.H, nw)) in calls
    assert ("popcount_words", None, (REPLICAS, 16, 3, nl, k, teth2.H, nw)) in calls
    # the commit's merge: one [R, N, H, nw] level against the verified rows
    assert ("popcount_binop", "and", (REPLICAS, 16, teth2.H, nw)) in calls
