"""The port's node aspects and every registered node builder against the
JAX package.

All 54 builder names (AWS, CITIES, RANDOM x constant or UniformSpeed x
the nine Tor ratios) build 300 nodes from one JavaRandom seed through both
packages: positions, cities, speed ratios, extra latencies and the engine
columns are equal, and the two random streams are still in step after
the population (the speed ratio draws before the extra latency).  The
speed models draw the JAX package's values, and an aspect is matched by
its exact type.
"""

import numpy as np
import pytest

from wittgenstein_tpu.core import node as jnode
from wittgenstein_tpu.core.registries import registry_network_latencies as jlats
from wittgenstein_tpu.core.registries import registry_node_builders as jbuilders
from wittgenstein_tpu.utils.javarand import JavaRandom as JRandom
from wittgenstein_tpu_torch.core import node as tnode
from wittgenstein_tpu_torch.core.registries import (
    CITIES,
    LOCATIONS,
    TOR_RATIOS,
    builder_name,
    registry_network_latencies as tlats,
    registry_node_builders as tbuilders,
)
from wittgenstein_tpu_torch.utils.javarand import JavaRandom as TRandom

NAMES = [builder_name(loc, c, tor) for loc in LOCATIONS for c in (True, False)
         for tor in TOR_RATIOS]


def test_the_54_names():
    assert len(NAMES) == 54 == len(set(NAMES))
    assert tbuilders.names() == jbuilders.names() == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_population_matches(name):
    seed = NAMES.index(name)
    jrd, trd = JRandom(seed), TRandom(seed)
    jnb, tnb = jbuilders.get_by_name(name), tbuilders.get_by_name(name)
    assert [type(a).__name__ for a in tnb.aspects] == [type(a).__name__ for a in jnb.aspects]
    jn = [jnode.Node(jrd, jnb) for _ in range(300)]
    tn = [tnode.Node(trd, tnb) for _ in range(300)]
    assert jrd.next_long() == trd.next_long()
    for f in ("node_id", "x", "y", "city_name", "speed_ratio", "extra_latency"):
        assert [getattr(n, f) for n in tn] == [getattr(n, f) for n in jn], f
    index = jlats.get_by_name("NetworkLatencyByCity").city_index if CITIES in name else None
    want, got = jnode.build_node_columns(jn, index), tnode.build_node_columns(tn, index)
    assert set(want) == set(got)
    for k in want:
        assert want[k].dtype == got[k].dtype and np.array_equal(want[k], got[k]), k
    if "GAUSSIAN" in name:
        assert len(set(got["speed_ratio"].tolist())) > 10
    tor = float(name.split("=")[-1])
    if tor > 0.001:
        assert set(got["extra_latency"].tolist()) <= {0, 500}


def test_cities_index_reaches_the_columns():
    """The CITIES builder's cities are all in the city matrix's index."""
    name = builder_name(CITIES, False, 0.2)
    rd = TRandom(3)
    nb = tbuilders.get_by_name(name)
    cols = tnode.build_node_columns([tnode.Node(rd, nb) for _ in range(500)],
                                    tlats.get_by_name("NetworkLatencyByCityWJitter").city_index)
    assert (cols["city_idx"] >= 0).all() and len(set(cols["city_idx"].tolist())) > 20


@pytest.mark.parametrize("model", ["pareto", "gaussian", "uniform"])
def test_speed_models_draw_the_same(model):
    make = {
        "pareto": lambda m: m.ParetoSpeed(1.2, 0.1, 0.35, 3.0),
        "gaussian": lambda m: m.GaussianSpeed(),
        "uniform": lambda m: m.UniformSpeed(),
    }[model]
    jrd, trd = JRandom(11), TRandom(11)
    jm, tm = make(jnode), make(tnode)
    want = [jm.get_speed_ratio(jrd) for _ in range(2000)]
    got = [tm.get_speed_ratio(trd) for _ in range(2000)]
    assert got == want
    assert jrd.next_int() == trd.next_int()


def test_builder_with_pareto_and_gaussian_aspects():
    """A hand-built builder with both aspects: the speed draws first."""
    def build(m, speed):
        nb = m.NodeBuilderWithRandomPosition()
        nb.aspects.append(m.ExtraLatencyAspect(0.4))
        nb.aspects.append(m.SpeedRatioAspect(speed(m)))
        return nb

    for speed in (lambda m: m.ParetoSpeed(1.2, 0.1, 0.35, 3.0), lambda m: m.GaussianSpeed()):
        jrd, trd = JRandom(5), TRandom(5)
        jnb, tnb = build(jnode, speed), build(tnode, speed)
        jn = [jnode.Node(jrd, jnb) for _ in range(200)]
        tn = [tnode.Node(trd, tnb) for _ in range(200)]
        for f in ("x", "y", "speed_ratio", "extra_latency"):
            assert [getattr(n, f) for n in tn] == [getattr(n, f) for n in jn], f


def test_aspects_match_by_exact_type():
    """A subclass of an aspect is not that aspect (`type(a) is cls`)."""
    class Tor(tnode.ExtraLatencyAspect):
        pass

    class JTor(jnode.ExtraLatencyAspect):
        pass

    tnb, jnb = tnode.NodeBuilderWithRandomPosition(), jnode.NodeBuilderWithRandomPosition()
    tnb.aspects.append(Tor(1.0))
    jnb.aspects.append(JTor(1.0))
    trd, jrd = TRandom(2), JRandom(2)
    tn, jn = tnode.Node(trd, tnb), jnode.Node(jrd, jnb)
    assert tn.extra_latency == jn.extra_latency == 0
    assert trd.next_int() == jrd.next_int()


def test_copy_resets_ids_and_shares_aspects():
    nb = tbuilders.get_by_name(builder_name("RANDOM", False, 0.5))
    rd = TRandom(0)
    assert [tnode.Node(rd, nb).node_id for _ in range(3)] == [0, 1, 2]
    again = nb.copy()
    assert tnode.Node(rd, again).node_id == 0
    assert again.aspects is nb.aspects
    assert tbuilders.get_by_name(builder_name("RANDOM", False, 0.5)).aspects is nb.aspects


def test_bad_speed_ratio_and_unknown_name_raise():
    class Zero(tnode.SpeedModel):
        def get_speed_ratio(self, rd):
            return 0.0

    nb = tnode.NodeBuilderWithRandomPosition()
    nb.aspects.append(tnode.SpeedRatioAspect(Zero()))
    with pytest.raises(ValueError, match="speedRatio"):
        tnode.Node(TRandom(0), nb)
    with pytest.raises(NotImplementedError):
        tnode.SpeedModel().get_speed_ratio(TRandom(0))
    for reg in (tbuilders, jbuilders):
        with pytest.raises(ValueError, match="not in the registry"):
            reg.get_by_name("MARS_SPEED=CONSTANT_TOR=0.00")
