"""The port's node populations and latency models against the JAX package.

The port keeps its own copies of JavaRandom, the default and AWS node
builders with the AWS city table, and the distance+jitter, AWS-region,
IC3, fixed, uniform and no-latency models; they must reproduce the JAX package's node columns
(same JavaRandom stream, draw for draw) and its vectorized latencies over
random node pairs and deltas, bit for bit.  The AWS model runs both as
the batched path feeds it (every `city_idx` -1, so every latency is 1 ms,
the JAX package's behaviour) and with real region indices 0-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wittgenstein_tpu.core import latency as jlat
from wittgenstein_tpu.core.geo import GeoAWS as JGeoAWS
from wittgenstein_tpu.core.node import Node as JNode
from wittgenstein_tpu.core.node import build_node_columns as jcols
from wittgenstein_tpu.core.registries import (
    builder_name as jbuilder_name,
    registry_network_latencies as jlats,
    registry_node_builders as jbuilders,
)
from wittgenstein_tpu.oracle.network import Network as JNetwork
from wittgenstein_tpu.utils.javarand import JavaRandom as JRandom
from wittgenstein_tpu_torch.core import latency as tlat
from wittgenstein_tpu_torch.core.geo import GeoAWS as TGeoAWS
from wittgenstein_tpu_torch.core.node import Node as TNode
from wittgenstein_tpu_torch.core.node import build_node_columns as tcols
from wittgenstein_tpu_torch.core.registries import (
    builder_name,
    registry_network_latencies as tlats,
    registry_node_builders as tbuilders,
)
from wittgenstein_tpu_torch.protocols.handel import choose_bad_nodes
from wittgenstein_tpu_torch.utils.javarand import JavaRandom as TRandom


AWS_BUILDER = builder_name("AWS", True, 0.0)


def _columns(n, seed, builder=None, city_index=None):
    jrd, trd = JRandom(seed), TRandom(seed)
    jnb, tnb = jbuilders.get_by_name(builder), tbuilders.get_by_name(builder)
    jn = [JNode(jrd, jnb) for _ in range(n)]
    tn = [TNode(trd, tnb) for _ in range(n)]
    # the streams stay in step after the population
    assert jrd.next_long() == trd.next_long()
    assert [nd.city_name for nd in jn] == [nd.city_name for nd in tn]
    return jcols(jn, city_index), tcols(tn, city_index)


@pytest.mark.parametrize("seed", [0, 7])
def test_node_columns_4096(seed):
    want, got = _columns(4096, seed)
    assert set(want) == set(got)
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        assert np.array_equal(want[k], got[k]), k


def test_bad_node_draw_matches():
    jrd, trd = JRandom(0), TRandom(0)
    assert JNetwork.choose_bad_nodes(jrd, 4096, 1024) == choose_bad_nodes(trd, 4096, 1024)
    assert jrd.next_int() == trd.next_int()


def test_latency_table_matches():
    assert np.array_equal(
        tlat.NetworkLatencyByDistanceWJitter._table(),
        jlat.NetworkLatencyByDistanceWJitter._table(),
    )
    assert np.array_equal(tlat.JITTER_TABLE, jlat.JITTER_TABLE)


def test_vec_latency_matches():
    n, m = 4096, 50_000
    cols = [_columns(n, s) for s in (0, 3)]  # two replicas, two layouts
    rng = np.random.RandomState(0)
    frm = rng.randint(0, n, size=(2, m)).astype(np.int32)
    to = rng.randint(0, n, size=(2, m)).astype(np.int32)
    to[:, :100] = frm[:, :100]  # from == to short-circuit
    delta = rng.randint(0, 100, size=(2, m)).astype(np.int32)
    jmodel, tmodel = jlats.get_by_name(None), tlats.get_by_name(None)

    def col(name):
        return torch.from_numpy(np.stack([c[1][name] for c in cols]))

    static = tlat.LatencyStatic(col("x"), col("y"), col("extra_latency"), col("city_idx"))
    got = tlat.vec_latency(
        tmodel, static, torch.from_numpy(frm), torch.from_numpy(to), torch.from_numpy(delta)
    ).numpy()
    for r in range(2):
        want = np.asarray(
            jlat.vec_latency(
                jmodel,
                jlat.LatencyStatic.from_columns(cols[r][0]),
                jnp.asarray(frm[r]),
                jnp.asarray(to[r]),
                jnp.asarray(delta[r]),
            )
        )
        assert got.dtype == want.dtype == np.int32
        assert np.array_equal(got[r], want)
    assert (got[:, :100] == 1).all()


def test_only_default_models_are_registered():
    """Every registered name resolves to the JAX package's class (the full
    registries: tests/test_torch_registries.py and
    tests/test_torch_latency_city.py); a name neither registry knows
    raises ValueError in both, and names itself."""
    assert builder_name("AWS", True, 0.0) == jbuilder_name("AWS", True, 0.0) == AWS_BUILDER
    for name in (None, "NetworkLatencyByDistanceWJitter", "AwsRegionNetworkLatency",
                 "IC3NetworkLatency", "NetworkLatencyByCity", "NetworkLatencyByCityWJitter",
                 "EthScanNetworkLatency", "NetworkFixedLatency(100)",
                 "NetworkUniformLatency(8000)"):
        assert type(tlats.get_by_name(name)).__name__ == type(jlats.get_by_name(name)).__name__
    for name in (None, AWS_BUILDER, builder_name("CITIES", True, 0.0),
                 builder_name("CITIES", False, 0.0), builder_name("AWS", False, 0.0),
                 builder_name("AWS", True, 0.1), builder_name("RANDOM", True, 0.33)):
        assert type(tbuilders.get_by_name(name)).__name__ == type(
            jbuilders.get_by_name(name)).__name__
    for reg in (tbuilders, jbuilders):
        with pytest.raises(ValueError, match="RANDOM_SPEED=FAST"):
            reg.get_by_name("RANDOM_SPEED=FAST")
    for reg in (tlats, jlats):
        for name in ("NetworkFixedLatency(7)", "NetworkUniformLatency(7)", "NoSuchLatency"):
            with pytest.raises(ValueError, match=name.split("(")[0]):
                reg.get_by_name(name)


def test_aws_city_table_matches():
    assert TGeoAWS.CITY_POS == JGeoAWS.CITY_POS
    want, got = JGeoAWS().cities_position(), TGeoAWS().cities_position()
    assert list(want) == list(got)
    for name, info in want.items():
        assert (info.merc_x, info.merc_y, info.cumulative_probability) == (
            got[name].merc_x, got[name].merc_y, got[name].cumulative_probability)
    jnb, tnb = jbuilders.get_by_name(AWS_BUILDER), tbuilders.get_by_name(AWS_BUILDER)
    assert tnb.cities == jnb.cities and list(tnb.cities_info) == list(jnb.cities_info)
    assert tlat.AwsRegionNetworkLatency.cities() == jlat.AwsRegionNetworkLatency.cities()
    assert np.array_equal(tlat.AwsRegionNetworkLatency.ONEWAY, jlat.AwsRegionNetworkLatency.ONEWAY)
    assert tlat.AWS_REGION_PER_CITY == jlat.AWS_REGION_PER_CITY


@pytest.mark.parametrize("n", [83, 1027])
def test_aws_node_columns(n):
    """CasperIMD's population sizes at its defaults and at 1024 attesters:
    every node sits in one of the 11 AWS cities, the JAX package's."""
    want, got = _columns(n, 0, AWS_BUILDER)
    for k in want:
        assert want[k].dtype == got[k].dtype and np.array_equal(want[k], got[k]), k
    assert 1 < len({(x, y) for x, y in zip(got["x"], got["y"])}) <= 11
    assert (got["city_idx"] == -1).all()  # no city index: the batched path's columns


def test_ic3_table_matches():
    assert np.array_equal(tlat.IC3NetworkLatency._table(), jlat.IC3NetworkLatency._table())


def _vec_pairs(name, cols, n, m=20_000):
    """vec_latency of model `name` in both packages over seeded random
    pairs and deltas of two replicas' columns; returns (JAX, port)."""
    rng = np.random.RandomState(1)
    frm = rng.randint(0, n, size=(2, m)).astype(np.int32)
    to = rng.randint(0, n, size=(2, m)).astype(np.int32)
    to[:, :100] = frm[:, :100]  # from == to short-circuit
    delta = rng.randint(0, 100, size=(2, m)).astype(np.int32)

    def col(k):
        return torch.from_numpy(np.stack([c[1][k] for c in cols]))

    static = tlat.LatencyStatic(col("x"), col("y"), col("extra_latency"), col("city_idx"))
    got = tlat.vec_latency(tlats.get_by_name(name), static, torch.from_numpy(frm),
                           torch.from_numpy(to), torch.from_numpy(delta)).numpy()
    want = np.stack([
        np.asarray(jlat.vec_latency(
            jlats.get_by_name(name), jlat.LatencyStatic.from_columns(cols[r][0]),
            jnp.asarray(frm[r]), jnp.asarray(to[r]), jnp.asarray(delta[r])))
        for r in range(2)
    ])
    assert got.dtype == want.dtype == np.int32
    assert (got[:, :100] == 1).all()
    return want, got


@pytest.mark.parametrize("builder", [None, AWS_BUILDER])
def test_ic3_vec_latency_matches(builder):
    cols = [_columns(1027, s, builder) for s in (0, 5)]
    want, got = _vec_pairs("IC3NetworkLatency", cols, 1027)
    assert np.array_equal(want, got)
    assert len(np.unique(got)) > 3


def test_aws_vec_latency_batched_columns_are_one_ms():
    """The batched path passes no city index, so every node's region is
    -1, JAX's `m[-1, -1]` takes the same-region branch, and every latency
    is 1 ms; the port reproduces it."""
    cols = [_columns(1027, s, AWS_BUILDER) for s in (0, 5)]
    want, got = _vec_pairs("AwsRegionNetworkLatency", cols, 1027)
    assert np.array_equal(want, got)
    assert (got == 1).all()


def test_aws_vec_latency_with_regions():
    """With real region indices (0-10, the scalar model's), the port's
    vectorized AWS model still equals the JAX package's: the node builder's
    own regions (its cumulative sums never reach London's 1.0 + 2 ulp
    from a draw of 10/11, so it picks 10 of the 11), then all 11 drawn
    at random."""
    index = dict(tlat.AWS_REGION_PER_CITY)
    cols = [_columns(1027, s, AWS_BUILDER, index) for s in (0, 5)]
    for c in cols:
        assert c[0]["city_idx"].min() == 0 and c[0]["city_idx"].max() == 9
    want, got = _vec_pairs("AwsRegionNetworkLatency", cols, 1027)
    assert np.array_equal(want, got)
    rng = np.random.RandomState(2)
    for c in cols:
        regions = rng.randint(0, 11, size=1027).astype(np.int32)
        c[0]["city_idx"], c[1]["city_idx"] = regions, regions.copy()
    want, got = _vec_pairs("AwsRegionNetworkLatency", cols, 1027)
    assert np.array_equal(want, got)
    assert got.max() > 100 and (got[:, 100:] == 1).mean() < 0.2


SIMPLE_MODELS = (
    [f"NetworkFixedLatency({f})" for f in (0, 100, 200, 500, 1000, 2000, 4000, 8000)]
    + [f"NetworkUniformLatency({f})" for f in (0, 100, 200, 500, 1000, 2000, 4000, 8000)]
    + ["NetworkNoLatency"]
)


def test_simple_models_resolve_as_in_jax():
    """The FIXED / UNIFORM names the JAX package pre-registers at 0..8000
    and NetworkNoLatency by class name resolve to the same classes and
    values; the registry's name() gives the JAX names."""
    for type_ in (tlats.FIXED, tlats.UNIFORM):
        for f in tlats.PRESET:
            assert tlats.name(type_, f) == jlats.name(type_, f)
    assert tlats.PRESET == (0, 100, 200, 500, 1000, 2000, 4000, 8000)
    for name in SIMPLE_MODELS:
        t, j = tlats.get_by_name(name), jlats.get_by_name(name)
        assert type(t).__name__ == type(j).__name__, name
        assert str(t) == str(j), name
        for attr in ("fixed_latency", "max_latency"):
            assert getattr(t, attr, None) == getattr(j, attr, None), name


@pytest.mark.parametrize("name", SIMPLE_MODELS)
def test_simple_models_ext_vec_match(name):
    """ext_vec on random deltas 0..99 (all of them among the first rows)
    and random index pairs, bit for bit, and through vec_latency; the
    scalar get_extended_latency on every delta."""
    cols = [_columns(100, s) for s in (0, 5)]
    want, got = _vec_pairs(name, cols, 100)
    assert np.array_equal(want, got)
    rng = np.random.RandomState(4)
    frm = rng.randint(0, 100, size=(2, 500)).astype(np.int32)
    to = rng.randint(0, 100, size=(2, 500)).astype(np.int32)
    delta = rng.randint(0, 100, size=(2, 500)).astype(np.int32)
    delta[:, :100] = np.arange(100)
    t, j = tlats.get_by_name(name), jlats.get_by_name(name)
    got = t.ext_vec(None, torch.from_numpy(frm), torch.from_numpy(to),
                    torch.from_numpy(delta)).numpy()
    want = np.stack([np.asarray(j.ext_vec(None, jnp.asarray(frm[r]), jnp.asarray(to[r]),
                                          jnp.asarray(delta[r]))) for r in range(2)])
    assert got.dtype == want.dtype == np.int32 and np.array_equal(got, want)
    for d in range(100):
        assert t.get_extended_latency(None, None, d) == j.get_extended_latency(None, None, d)
