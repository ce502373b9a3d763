"""The port's node population and latency model against the JAX package.

The port keeps its own copies of JavaRandom, the default node builder and
the distance+jitter latency model; they must reproduce the JAX package's
node columns at 4096 nodes (same JavaRandom stream, draw for draw) and
its vectorized latencies over random node pairs and deltas, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wittgenstein_tpu.core import latency as jlat
from wittgenstein_tpu.core.node import Node as JNode
from wittgenstein_tpu.core.node import build_node_columns as jcols
from wittgenstein_tpu.core.registries import (
    registry_network_latencies as jlats,
    registry_node_builders as jbuilders,
)
from wittgenstein_tpu.oracle.network import Network as JNetwork
from wittgenstein_tpu.utils.javarand import JavaRandom as JRandom
from wittgenstein_tpu_torch.core import latency as tlat
from wittgenstein_tpu_torch.core.node import Node as TNode
from wittgenstein_tpu_torch.core.node import build_node_columns as tcols
from wittgenstein_tpu_torch.core.registries import (
    registry_network_latencies as tlats,
    registry_node_builders as tbuilders,
)
from wittgenstein_tpu_torch.protocols.handel import choose_bad_nodes
from wittgenstein_tpu_torch.utils.javarand import JavaRandom as TRandom


def _columns(n, seed):
    jrd, trd = JRandom(seed), TRandom(seed)
    jnb, tnb = jbuilders.get_by_name(None), tbuilders.get_by_name(None)
    jn = [JNode(jrd, jnb) for _ in range(n)]
    tn = [TNode(trd, tnb) for _ in range(n)]
    # the streams stay in step after the population
    assert jrd.next_long() == trd.next_long()
    return jcols(jn), tcols(tn)


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
    with pytest.raises(NotImplementedError):
        tbuilders.get_by_name("AWS_SPEED=CONSTANT_TOR=0.00")
    with pytest.raises(NotImplementedError):
        tlats.get_by_name("NetworkLatencyByCity")
