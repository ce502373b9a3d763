"""The port's city-matrix and measured latency models against the JAX
package.

The port keeps its own copy of the baked city matrix
(`data/city_latency.npz`, byte for byte the JAX package's), read by its
`CSVLatencyReader`.  `NetworkLatencyByCity`, `NetworkLatencyByCityWJitter`,
`MeasuredNetworkLatency` and `EthScanNetworkLatency` give the JAX
package's latencies: the vectorized forms over seeded [R, K] index
tensors whose pairs include the same node, the same city, nodes outside
the city index (city_idx -1, which JAX's gather reads as the last city)
and the last city itself; the scalar forms over node pairs.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wittgenstein_tpu.core import latency as jlat
from wittgenstein_tpu.core.node import Node as JNode
from wittgenstein_tpu.core.node import build_node_columns as jcols
from wittgenstein_tpu.core.registries import registry_network_latencies as jlats
from wittgenstein_tpu.core.registries import registry_node_builders as jbuilders
from wittgenstein_tpu.tools import latency_csv as jcsv
from wittgenstein_tpu.utils.javarand import JavaRandom as JRandom
from wittgenstein_tpu_torch.core import geo
from wittgenstein_tpu_torch.core import latency as tlat
from wittgenstein_tpu_torch.core.node import Node as TNode
from wittgenstein_tpu_torch.core.node import build_node_columns as tcols
from wittgenstein_tpu_torch.core.registries import builder_name
from wittgenstein_tpu_torch.core.registries import registry_network_latencies as tlats
from wittgenstein_tpu_torch.core.registries import registry_node_builders as tbuilders
from wittgenstein_tpu_torch.tools import latency_csv as tcsv
from wittgenstein_tpu_torch.utils.javarand import JavaRandom as TRandom

CITY_MODELS = ["NetworkLatencyByCity", "NetworkLatencyByCityWJitter"]
MODELS = CITY_MODELS + ["EthScanNetworkLatency", "measured"]
N = 300
CITIES = builder_name("CITIES", False, 0.2)


def _model(lib, regs, name):
    if name == "measured":
        return lib.MeasuredNetworkLatency([10, 0, 30, 20, 40], [120, 300, 310, 900, 5000])
    return regs.get_by_name(name)


def test_baked_matrix_is_the_jax_packages():
    digest = [hashlib.sha256(p.read_bytes()).hexdigest()
              for p in (tcsv.BAKED, type(tcsv.BAKED)(jcsv._BAKED))]
    assert digest[0] == digest[1]
    t, j = tcsv.CSVLatencyReader(), jcsv.CSVLatencyReader()
    assert t.cities() == j.cities() == geo.latency_cities()
    assert len(t.cities()) == 219
    assert t.city_index() == j.city_index()
    assert t.matrix().dtype == np.float32 and np.array_equal(t.matrix(), j.matrix())
    for a, b in (("Adelaide", "Ankara"), ("Ankara", "Adelaide"), ("Albany", "Albany")):
        assert t.get_latency(a, b) == j.get_latency(a, b)


def _populations(seed):
    jrd, trd = JRandom(seed), TRandom(seed)
    jnb, tnb = jbuilders.get_by_name(CITIES), tbuilders.get_by_name(CITIES)
    return [JNode(jrd, jnb) for _ in range(N)], [TNode(trd, tnb) for _ in range(N)]


def _columns():
    """Two replicas' columns; in each, node 0 and node 1 lie outside the
    city index (-1) and node 2 in the last city."""
    index = tlats.get_by_name("NetworkLatencyByCity").city_index
    out = []
    for seed in (0, 9):
        jn, tn = _populations(seed)
        cols = tcols(tn, index)
        want = jcols(jn, index)
        for k in want:
            assert np.array_equal(want[k], cols[k]), k
        cols["city_idx"][[0, 1]] = -1
        cols["city_idx"][2] = len(index) - 1
        out.append(cols)
    return out


def _pairs(cols):
    """[2, K] from/to: random pairs, then same node, same city, the -1
    nodes with each other, with the last city and with others."""
    rng = np.random.RandomState(4)
    k = 4000
    frm = rng.randint(0, N, size=(2, k)).astype(np.int32)
    to = rng.randint(0, N, size=(2, k)).astype(np.int32)
    to[:, :50] = frm[:, :50]
    for r, c in enumerate(cols):
        city = c["city_idx"]
        same = [(i, j) for i in range(3, N) for j in range(i + 1, N) if city[i] == city[j]]
        assert len(same) > 20
        frm[r, 50:70], to[r, 50:70] = np.array(same[:20]).T
    frm[:, 70:80], to[:, 70:80] = 0, 1
    frm[:, 80:90], to[:, 80:90] = 0, 2
    frm[:, 90:100], to[:, 90:100] = 2, 1
    frm[:, 100:200] = 0
    delta = rng.randint(0, 100, size=(2, k)).astype(np.int32)
    return frm, to, delta


@pytest.mark.parametrize("name", MODELS)
def test_vectorized_forms_match(name):
    cols = _columns()
    frm, to, delta = _pairs(cols)
    jmodel, tmodel = _model(jlat, jlats, name), _model(tlat, tlats, name)

    def col(f):
        return torch.from_numpy(np.stack([c[f] for c in cols]))

    static = tlat.LatencyStatic(col("x"), col("y"), col("extra_latency"), col("city_idx"))
    args = [torch.from_numpy(a) for a in (frm, to, delta)]
    got_ext = tmodel.ext_vec(static, *args).numpy()
    got = tlat.vec_latency(tmodel, static, *args).numpy()
    for r in range(2):
        jstatic = jlat.LatencyStatic.from_columns(cols[r])
        jargs = [jnp.asarray(a[r]) for a in (frm, to, delta)]
        want_ext = np.asarray(jmodel.ext_vec(jstatic, *jargs))
        want = np.asarray(jlat.vec_latency(jmodel, jstatic, *jargs))
        assert got_ext[r].dtype == want_ext.dtype
        assert np.array_equal(got_ext[r], want_ext)
        assert got.dtype == want.dtype == np.int32 and np.array_equal(got[r], want)


@pytest.mark.parametrize("name", MODELS)
def test_scalar_forms_match(name):
    jn, tn = _populations(5)
    jmodel, tmodel = _model(jlat, jlats, name), _model(tlat, tlats, name)
    rng = np.random.RandomState(1)
    pairs = [(i, i) for i in range(5)] + [tuple(p) for p in rng.randint(0, N, size=(400, 2))]
    city = [n.city_name for n in tn]
    pairs += [(i, j) for i in range(N) for j in range(i + 1, N) if city[i] == city[j]][:30]
    for i, j in pairs:
        d = int(rng.randint(0, 100))
        assert tmodel.get_extended_latency(tn[i], tn[j], d) == \
            jmodel.get_extended_latency(jn[i], jn[j], d), (i, j, d)
        assert tmodel.get_latency(tn[i], tn[j], d) == jmodel.get_latency(jn[i], jn[j], d)


def test_default_city_and_bad_delta_raise():
    rd = TRandom(0)
    nb = tbuilders.get_by_name(None)
    a, b = TNode(rd, nb), TNode(rd, nb)
    for name in CITY_MODELS:
        with pytest.raises(ValueError, match="default city"):
            tlats.get_by_name(name).get_extended_latency(a, b, 3)
    with pytest.raises(ValueError, match="delta"):
        _model(tlat, tlats, "measured").get_extended_latency(a, b, 100)


def test_measured_tables_match():
    for props, vals in (([10, 0, 30, 20, 40], [120, 300, 310, 900, 5000]),
                        (jlat.EthScanNetworkLatency.DISTRIB_PROP,
                         jlat.EthScanNetworkLatency.DISTRIB_VAL),
                        ([100], [-7]), ([33, 33, 34], [5, -60, 1000])):
        t = tlat.MeasuredNetworkLatency(props, vals).long_distrib
        j = jlat.MeasuredNetworkLatency(props, vals).long_distrib
        assert t.dtype == j.dtype == np.int64 and np.array_equal(t, j)
    for lib in (tlat, jlat):
        with pytest.raises(ValueError, match="sum to 100"):
            lib.MeasuredNetworkLatency([50, 40], [10, 20])


def test_aws_compares_region_indices_as_stored():
    """A node outside the region index (-1) against the last region (10):
    JAX compares -1 with 10 (different), then reads the last region's row."""
    rng = np.random.RandomState(2)
    n, k = 40, 600
    city = rng.randint(-1, 11, size=n).astype(np.int32)
    city[:3] = [-1, 10, -1]
    frm = rng.randint(0, n, size=k).astype(np.int32)
    to = rng.randint(0, n, size=k).astype(np.int32)
    frm[:20], to[:20] = 0, 1
    delta = rng.randint(0, 100, size=k).astype(np.int32)
    zeros = np.zeros(n, np.int32)
    jstatic = jlat.LatencyStatic(zeros + 1, zeros + 1, zeros, city)
    want = np.asarray(jlat.AwsRegionNetworkLatency().ext_vec(
        jstatic, jnp.asarray(frm), jnp.asarray(to), jnp.asarray(delta)))
    t = lambda a: torch.from_numpy(a)[None]  # noqa: E731
    static = tlat.LatencyStatic(t(zeros + 1), t(zeros + 1), t(zeros), t(city))
    got = tlat.AwsRegionNetworkLatency().ext_vec(static, t(frm), t(to), t(delta)).numpy()[0]
    assert np.array_equal(got, want)
    assert (want[:20] != 1).any()


def test_registry_names_match():
    names = list(jlats._registry) + ["NetworkLatencyByDistanceWJitter",
                                     "AwsRegionNetworkLatency", "NetworkLatencyByCity",
                                     "NetworkLatencyByCityWJitter", "NetworkNoLatency",
                                     "EthScanNetworkLatency", "IC3NetworkLatency", None]
    for name in names:
        t, j = tlats.get_by_name(name), jlats.get_by_name(name)
        assert type(t).__name__ == type(j).__name__ and str(t) == str(j), name
    for reg in (tlats, jlats):
        for bad in ("NetworkFixedLatency(7)", "NetworkLatencyByMoon"):
            with pytest.raises(ValueError, match="unknown latency model"):
                reg.get_by_name(bad)
