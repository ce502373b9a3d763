"""Batched CasperIMD's other producer variants and latency models, leaf for leaf.

The companion of test_torch_casper.py (split so the two files run side by
side): two replicas at the defaults over 40 000 ms (five slots) for the
head-start producer "delay" (3000 ms into its slot) and the "ns"
producer, for the AWS-region and IC3 latency models (the AWS run's
latencies are all 1 ms on the batched path, as in the JAX package), for
the deterministic tie-break (`random_on_ties=False`), and with three
block producers, two of them honest, writing the block table in turn.
"""

import jax
import numpy as np
import pytest
import torch

from wittgenstein_tpu.engine import replicate_state as jreplicate
from wittgenstein_tpu.protocols.casper import CasperParameters as JParams
from wittgenstein_tpu.protocols.casper_batched import make_casper as jmake
from wittgenstein_tpu_torch.core.registries import builder_name
from wittgenstein_tpu_torch.engine import replicate_state as treplicate
from wittgenstein_tpu_torch.interop import state_to_numpy
from wittgenstein_tpu_torch.protocols.casper import CasperParameters as TParams
from wittgenstein_tpu_torch.protocols.casper_batched import make_casper as tmake

REPLICAS = 2
MAX_HEIGHTS = 16
SIM_MS = 40_000
# name: (parameters, byz_variant, byz_delay)
CASES = {
    "delay": ({}, "delay", 3000),
    "ns": ({}, "ns", 0),
    "aws": (dict(node_builder_name=builder_name("AWS", True, 0.0),
                 network_latency_name="AwsRegionNetworkLatency"), "wf", 0),
    "ic3": (dict(network_latency_name="IC3NetworkLatency"), "wf", 0),
    "ties_by_time": (dict(random_on_ties=False), "wf", 0),
    "three_producers": (dict(block_producers_count=3), "wf", 0),
}


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
    """Every leaf equal in name, dtype, shape and bits."""
    assert set(want) == set(got), tag
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
        else:
            assert g == w == (), f"{tag}: side-car {f}"


@pytest.mark.parametrize("case", list(CASES))
def test_run_matches(case):
    kw, variant, delay = CASES[case]
    jnet, jstate = jmake(JParams(**kw), max_heights=MAX_HEIGHTS, byz_variant=variant,
                         byz_delay=delay)
    tnet, tstate = tmake(TParams(**kw), max_heights=MAX_HEIGHTS, byz_variant=variant,
                         byz_delay=delay, device="cpu")
    assert_same_state(jax_numpy(jreplicate(jstate, 1)), state_to_numpy(treplicate(tstate, 1)),
                      "initial state")
    want = jax_numpy(jnet.run_ms_batched(jreplicate(jstate, REPLICAS), SIM_MS))
    got = state_to_numpy(tnet.run_ms_batched(treplicate(tstate, REPLICAS), SIM_MS))
    assert_same_state(want, got, f"{case} after {SIM_MS} ms")
    p = got["proto"]
    # four blocks at least in every replica, and nothing dropped
    assert (p["blk_exists"].sum(-1) >= 5).all()
    assert (got["dropped"] == 0).all() and (got["time"] == SIM_MS).all()
    if case == "aws":
        # every latency is 1 ms: each block reaches every node the tick
        # after its send, 1 s after its slot starts
        assert (tnet.jump_stats["iterations"] < 40)
    if case == "three_producers":
        # the two honest producers (nodes 2 and 3) built in turn
        assert set(p["blk_parent"][0, 1:5].tolist()) <= {0, 1, 2, 3}
        assert int(p["blk_exists"][0].sum()) >= 5
