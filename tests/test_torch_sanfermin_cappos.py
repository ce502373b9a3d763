"""Batched SanFerminCappos in the port against the JAX package.

SanFerminCappos ticks every millisecond on the 512-row wheel.  Every leaf
after 3000 ms must equal the JAX package's, at 64 nodes with 4
candidates and with 50, which caps the contacts per send at 1 + N/2 (that
run stops once every node is done).  The
port runs only the descent passes that have an active node, where JAX
unrolls all W + 1 levels; on random states both must give the same
bits.
"""

import numpy as np
import pytest
import torch

from test_torch_paxos import assert_same_state, jax_numpy
from wittgenstein_tpu.engine import replicate_state as jreplicate
from wittgenstein_tpu.protocols.sanfermin_cappos import SanFerminParameters as JParams
from wittgenstein_tpu.protocols.sanfermin_cappos_batched import make_sanfermin_cappos as jmake
from wittgenstein_tpu_torch.engine import replicate_state as treplicate
from wittgenstein_tpu_torch.interop import state_to_numpy
from wittgenstein_tpu_torch.protocols.sanfermin_cappos import SanFerminParameters as TParams
from wittgenstein_tpu_torch.protocols.sanfermin_cappos_batched import (
    make_sanfermin_cappos as tmake,
)

REPLICAS = 2
SIM_MS = 3000
# the 50-candidate case stops once every node is done (tick 300 of 3000),
# in both packages; the 4-candidate case runs all 3000 ms, past its last
# completion (tick 397)
STOP_WHEN_DONE = {4: False, 50: True}


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


@pytest.mark.parametrize("candidates", [4, 50])
def test_cappos_matches(candidates):
    kw = dict(node_count=64, threshold=32, candidate_count=candidates)
    jnet, jstate = jmake(JParams(**kw))
    tnet, tstate = tmake(TParams(**kw), device="cpu")
    assert tnet.protocol.k == jnet.protocol.k == 1 + min(candidates, 32)
    assert_same_state(jax_numpy(jreplicate(jstate, 1)), state_to_numpy(treplicate(tstate, 1)),
                      "initial state")
    stop = STOP_WHEN_DONE[candidates]
    want = jax_numpy(jnet.run_ms_batched(jreplicate(jstate, REPLICAS), SIM_MS,
                                         stop_when_done=stop))
    got = state_to_numpy(tnet.run_ms_batched(treplicate(tstate, REPLICAS), SIM_MS, stop))
    assert_same_state(want, got, f"{candidates} candidates after {SIM_MS} ms")
    assert got["proto"]["done"].all() and (got["dropped"] == 0).all()


def _random_tick_state(net, state, r, rng):
    """A batch of r replicas with random caches, levels and commits."""
    n, w = net.protocol.n_nodes, net.protocol.w
    s = treplicate(state, r)
    proto = dict(s.proto)
    proto["cpl"] = torch.from_numpy(rng.randint(0, w, size=(r, n)).astype(np.int32))
    proto["cache_any"] = torch.from_numpy(rng.rand(r, n, w + 1) < 0.7)
    proto["cache_best"] = torch.from_numpy(rng.randint(0, 9, size=(r, n, w + 1)).astype(np.int32))
    proto["thr_done"] = torch.from_numpy(rng.rand(r, n) < 0.3)
    proto["done"] = torch.from_numpy(rng.rand(r, n) < 0.1)
    proto["swapping"] = torch.from_numpy(rng.rand(r, n) < 0.8)
    commit = torch.from_numpy(rng.rand(r, n) < 0.5) & ~proto["done"]
    return s, proto, commit


@pytest.mark.parametrize("seed", range(4))
def test_early_descent_equals_full_unroll(seed):
    """The passes `_descent_passes` counts give the state and the
    descended mask that all W + 1 passes give."""
    net, state = tmake(TParams(node_count=64, threshold=20, candidate_count=4), device="cpu")
    proto_ = net.protocol
    s, proto, commit = _random_tick_state(net, state, 3, np.random.RandomState(seed))
    passes = proto_._descent_passes(proto, commit)
    assert 0 < passes <= proto_.w
    full = proto_._descend(s, dict(proto), commit, 500, proto_.w + 1)
    short = proto_._descend(s, dict(proto), commit, 500, passes)
    assert torch.equal(full[0].done_at, short[0].done_at)
    assert torch.equal(full[2], short[2])
    for k in full[1]:
        assert torch.equal(full[1][k], short[1][k]), k
    # one pass fewer changes the result: the count is the least that will do
    fewer = proto_._descend(s, dict(proto), commit, 500, passes - 1)
    assert not all(torch.equal(full[1][k], fewer[1][k]) for k in full[1])
    assert proto_._descent_passes(proto, torch.zeros_like(commit)) == 0
