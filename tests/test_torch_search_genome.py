"""The port's genome, objectives and optimizers against the JAX package's.

The search core is host-side numpy in both packages, so the bar is
exact: the same seeds give the same `ask()` arrays, the same decoded
genomes and descriptions, the same lowered-plan digests (the port's
FaultPlan against the JAX package's), the same Pareto frontiers, and the
same optimizer state (`state_meta`, `state_arrays`) after `tell` with the
same scores, for all three optimizers; SHA keeps its row geometry and
restarts its ladder as the JAX package's does.
"""

import json

import numpy as np
import pytest

from wittgenstein_tpu import search as jsearch
from wittgenstein_tpu_torch import search as tsearch

KINDS = ("random", "es", "sha")


def _live(n, down):
    live = np.ones(n, bool)
    live[list(down)] = False
    return live


@pytest.mark.parametrize("sim_ms, n, down", [(1000, 100, range(0, 100, 10)), (1500, 64, ()),
                                             (7, 5, (1,))])
def test_genome_decode_describe_and_digest(sim_ms, n, down):
    live = _live(n, down)
    jg = jsearch.FaultGenome(sim_ms, n, live=live)
    tg = tsearch.FaultGenome(sim_ms, n, live=live)
    assert tg.spec.to_json() == jg.spec.to_json()
    assert np.array_equal(tg.spec.lo, jg.spec.lo) and np.array_equal(tg.spec.hi, jg.spec.hi)
    rng = np.random.Generator(np.random.PCG64(11))
    vecs = list(tg.spec.random(rng, 12)) + [tg.spec.center(), tg.spec.lo.copy(),
                                            tg.spec.hi.copy()]
    for vec in vecs:
        assert tg.spec.decode(vec) == jg.spec.decode(vec)
        assert tg.describe(vec) == jg.describe(vec)
        assert tg.to_plan(vec, "g").describe() == jg.to_plan(vec, "g").describe()
        for n_mt in (1, 3):
            assert tg.digest(vec, n_mt) == jg.digest(vec, n_mt)


def test_genome_spec_errors_match():
    for build in (lambda m: m.GeneSpec("x", 2.0, 1.0),
                  lambda m: m.GenomeSpec([m.GeneSpec("a", 0, 1), m.GeneSpec("a", 0, 1)]),
                  lambda m: m.GenomeSpec([]),
                  lambda m: m.FaultGenome(1, 4),
                  lambda m: m.FaultGenome(100, 4, live=np.ones(3, bool))):
        with pytest.raises(ValueError) as je:
            build(jsearch)
        with pytest.raises(ValueError) as te:
            build(tsearch)
        assert str(te.value) == str(je.value)
    spec = [tsearch.GenomeSpec([tsearch.GeneSpec("a", 0.0, 1.0),
                                tsearch.GeneSpec("b", 0.0, 10.0, integer=True)]),
            jsearch.GenomeSpec([jsearch.GeneSpec("a", 0.0, 1.0),
                                jsearch.GeneSpec("b", 0.0, 10.0, integer=True)])]
    for bad in ([0.5], [0.5, 11.0], [np.nan, 1.0]):
        msgs = []
        for s in spec:
            with pytest.raises(ValueError) as e:
                s.validate(bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    again = tsearch.GenomeSpec.from_json(json.loads(json.dumps(spec[1].to_json())))
    assert again.to_json() == spec[1].to_json()


def _records(rng, k, n_mt=3):
    out = []
    for i in range(k):
        done = rng.random() < 0.8
        out.append({
            "availability": round(float(rng.random()), 4),
            "done_at_ms": ({"p10": int(rng.integers(0, 300)), "p50": int(rng.integers(300, 600)),
                            "p90": int(rng.integers(600, 900)), "max": int(rng.integers(900, 999))}
                           if done else None),
            "dropped_by_fault": rng.integers(0, 50, n_mt).tolist(),
            "delayed_by_fault": rng.integers(0, 50, n_mt).tolist(),
            "reward_ratio": float(rng.random()),
        })
    return out


def test_objectives_and_frontier():
    assert list(tsearch.OBJECTIVES) == list(jsearch.OBJECTIVES)
    for name, obj in tsearch.OBJECTIVES.items():
        assert (obj.name, obj.doc) == (jsearch.OBJECTIVES[name].name, jsearch.OBJECTIVES[name].doc)
    rng = np.random.default_rng(5)
    recs = _records(rng, 40)
    for name in tsearch.OBJECTIVES:
        got = tsearch.score_records(recs, name, 1000)
        want = jsearch.score_records(recs, name, 1000)
        assert got.dtype == want.dtype == np.float64 and np.array_equal(got, want)
    with pytest.raises(KeyError) as je:
        jsearch.get_objective("nope")
    with pytest.raises(KeyError) as te:
        tsearch.get_objective("nope")
    assert str(te.value) == str(je.value)
    for pts in (rng.integers(0, 5, (30, 2)).astype(float), rng.random((25, 2)),
                [(1.0, 1.0), (1.0, 1.0), (0.0, 2.0), (0.5, 0.5)]):
        for maximize in ((True, True), (True, False), (False, False)):
            assert tsearch.pareto_frontier(pts, maximize) == jsearch.pareto_frontier(pts, maximize)


def _spec(m):
    return m.FaultGenome(1000, 100, live=_live(100, range(0, 100, 10))).spec


def _same_state(t_opt, j_opt):
    assert t_opt.state_meta() == j_opt.state_meta()
    ta, ja = t_opt.state_arrays(), j_opt.state_arrays()
    assert list(ta) == list(ja)
    for k in ja:
        assert ta[k].dtype == ja[k].dtype and np.array_equal(ta[k], ja[k]), k


@pytest.mark.parametrize("kind", KINDS)
def test_optimizer_ask_tell_state(kind):
    """Five generations with the same scores (ties among them): the same
    asks and the same state after every tell; a restored copy asks the
    same next generation."""
    t_opt = tsearch.make_optimizer(kind, _spec(tsearch), 8, seed=3)
    j_opt = jsearch.make_optimizer(kind, _spec(jsearch), 8, seed=3)
    rng = np.random.default_rng(9)
    for gen in range(5):
        pop_t, pop_j = t_opt.ask(), j_opt.ask()
        assert pop_t.dtype == pop_j.dtype and np.array_equal(pop_t, pop_j), gen
        assert t_opt.replicas_per_plan(2) == j_opt.replicas_per_plan(2)
        scores = np.round(rng.random(len(pop_j)) * 4) / 4  # ties on purpose
        t_opt.tell(pop_t, scores)
        j_opt.tell(pop_j, scores)
        _same_state(t_opt, j_opt)
        again = tsearch.make_optimizer(kind, _spec(tsearch), 8, seed=99)
        meta = json.loads(json.dumps(j_opt.state_meta()))
        again.load_state(j_opt.state_arrays(), meta)
        assert np.array_equal(again.ask(), _peek(j_opt))


def _peek(opt):
    """The next ask() of a copy of `opt`, leaving `opt` as it was."""
    state = json.loads(json.dumps(opt.state_meta()))
    arrays = {k: v.copy() for k, v in opt.state_arrays().items()}
    twin = type(opt)(opt.spec, opt.population, seed=opt.seed)
    twin.load_state(arrays, state)
    return twin.ask()


def test_sha_geometry_and_restart():
    for m in (tsearch, jsearch):
        with pytest.raises(ValueError):
            m.SuccessiveHalving(_spec(m), 6)
    t_opt = tsearch.SuccessiveHalving(_spec(tsearch), 8, seed=1)
    j_opt = jsearch.SuccessiveHalving(_spec(jsearch), 8, seed=1)
    assert t_opt.rungs == j_opt.rungs == 3
    rows = []
    for gen in range(7):
        pop_t, pop_j = t_opt.ask(), j_opt.ask()
        assert np.array_equal(pop_t, pop_j)
        rows.append((len(pop_t), t_opt.replicas_per_plan(1)))
        assert len(pop_t) * t_opt.replicas_per_plan(1) == 8  # the same row count
        scores = -np.arange(len(pop_t), dtype=np.float64)
        t_opt.tell(pop_t, scores)
        j_opt.tell(pop_j, scores)
        _same_state(t_opt, j_opt)
    assert rows == [(8, 1), (4, 2), (2, 4), (8, 1), (4, 2), (2, 4), (8, 1)]


def test_load_state_rejects_other_kind():
    es = tsearch.make_optimizer("es", _spec(tsearch), 4)
    rs = tsearch.make_optimizer("random", _spec(tsearch), 4)
    jes = jsearch.make_optimizer("es", _spec(jsearch), 4)
    jrs = jsearch.make_optimizer("random", _spec(jsearch), 4)
    with pytest.raises(ValueError) as te:
        rs.load_state(es.state_arrays(), es.state_meta())
    with pytest.raises(ValueError) as je:
        jrs.load_state(jes.state_arrays(), jes.state_meta())
    assert str(te.value) == str(je.value)
    with pytest.raises(KeyError):
        tsearch.make_optimizer("cma", _spec(tsearch), 4)
