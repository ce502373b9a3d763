"""Batched Dfinity in the port against the JAX package, leaf for leaf.

Dfinity is the event-driven protocol whose far-future beacon re-exchange
(parent proposal time + 2 rounds) lands past the 512-ms wheel horizon, so
its runs keep long-lived entries in the overflow lane while the engine
jumps over the dead time between rounds.  Both packages build the default
configuration (31 nodes: observer, 10 attesters, 10 producers, 10 beacons;
64 heights) from the same JavaRandom stream and run two replicas for
7000 ms; every leaf — the wheel, the overflow lane, the block table, the
vote and exchange counters — must agree exactly.
"""

import jax
import numpy as np
import pytest
import torch

from wittgenstein_tpu.engine import replicate_state as jreplicate
from wittgenstein_tpu.protocols.dfinity_batched import make_dfinity as jmake
from wittgenstein_tpu_torch.engine import replicate_state as treplicate
from wittgenstein_tpu_torch.interop import state_to_numpy
from wittgenstein_tpu_torch.protocols.dfinity_batched import make_dfinity as tmake

REPLICAS = 2
SIM_MS = 7000
ROLE_FIELDS = ("is_att", "is_bp", "is_bcn", "my_round", "bp_local", "att_ids", "bp_ids",
               "bcn_ids")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def jax_numpy(state) -> dict:
    d = jax.tree_util.tree_map(np.asarray, state)._asdict()
    d["proto"] = dict(d["proto"])
    return d


def assert_same_state(want: dict, got: dict, tag: str) -> None:
    for f, w in want.items():
        g = got[f]
        if f == "proto":
            assert set(w) == set(g), f"{tag}: proto keys"
            for k in w:
                assert w[k].dtype == g[k].dtype and w[k].shape == g[k].shape, f"{tag}: proto.{k}"
                assert np.array_equal(w[k], g[k]), f"{tag}: proto.{k} differs"
        elif isinstance(w, np.ndarray):
            assert w.dtype == g.dtype and w.shape == g.shape, f"{tag}: {f} dtype/shape"
            assert np.array_equal(w, g), f"{tag}: {f} differs"


@pytest.fixture(scope="module")
def both():
    jnet, jstate = jmake()
    tnet, tstate = tmake(device="cpu")
    return jnet, jstate, tnet, tstate


@pytest.fixture(scope="module")
def runs(both):
    jnet, jstate, tnet, tstate = both
    js = jnet.run_ms_batched(jreplicate(jstate, REPLICAS), SIM_MS)
    ts = tnet.run_ms_batched(treplicate(tstate, REPLICAS), SIM_MS)
    return jnet, js, tnet, ts


def test_population_and_roles_match(both):
    jnet, jstate, tnet, tstate = both
    for f in ROLE_FIELDS:
        want = np.asarray(getattr(jnet.protocol, f))
        got = getattr(tnet.protocol, f).numpy()
        assert want.dtype == got.dtype and np.array_equal(want, got), f
    assert tnet.protocol.n_nodes == 31 and tnet.protocol.max_b == 640
    assert (tnet.wheel_rows, tnet.wheel_slots, tnet.overflow_capacity) == (512, 64, 1024)
    assert_same_state(jax_numpy(jreplicate(jstate, 1)), state_to_numpy(treplicate(tstate, 1)),
                      "initial state")


def test_run_matches(runs):
    _, js, _, ts = runs
    want, got = jax_numpy(js), state_to_numpy(ts)
    assert_same_state(want, got, f"after {SIM_MS} ms")
    assert (got["dropped"] == 0).all()
    # far-future re-exchanges still wait in the overflow lane
    assert (got["ovf_valid"].sum(-1) > 0).all()
    assert (got["time"] == SIM_MS).all()


def test_head_height_matches(runs):
    jnet, js, tnet, ts = runs
    want = np.asarray(jax.vmap(jnet.protocol.head_height)(js))
    got = tnet.protocol.head_height(ts).numpy()
    assert np.array_equal(want, got)
    assert (got.max(-1) >= 2).all()  # notarized heights on every replica
