"""Batched P2PFlood in the port against the JAX package.

The port replays P2PFlood.init on the host: the P2P graph from the
oracle's JavaRandom stream, the dead nodes, and the sender picks, with
the shuffle and the send's seed draw that each accepted sender's flood
takes between two picks — with several floods they decide the next
sender.  The flood runs event-driven on the flat store.  Senders,
adjacency and every leaf after 2001 ms must equal the JAX package's
`make_p2pflood`, with one and three floods, under the default latency
model and NetworkNoLatency (the JAX package's own P2PFlood tests), with
and without the spacing between sends.
"""

import numpy as np
import pytest
import torch

from test_torch_paxos import assert_same_state, jax_numpy
from wittgenstein_tpu.engine import replicate_state as jreplicate
from wittgenstein_tpu.protocols.p2pflood import P2PFloodParameters as JParams
from wittgenstein_tpu.protocols.p2pflood_batched import make_p2pflood as jmake
from wittgenstein_tpu_torch.engine import replicate_state as treplicate
from wittgenstein_tpu_torch.interop import state_to_numpy
from wittgenstein_tpu_torch.protocols.p2pflood import P2PFloodParameters as TParams
from wittgenstein_tpu_torch.protocols.p2pflood_batched import make_p2pflood as tmake

REPLICAS = 2
SIM_MS = 2001
CASES = {
    f"{m}msg-{lat or 'default'}-delay{d}": dict(msg_count=m, network_latency_name=lat,
                                                delay_between_sends=d)
    for m in (1, 3) for lat in (None, "NetworkNoLatency") for d in (30, 0)
}


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


@pytest.mark.parametrize("case", list(CASES))
def test_flood_matches(case):
    kw = CASES[case]
    jnet, jstate = jmake(JParams(**kw))
    tnet, tstate = tmake(TParams(**kw), device="cpu")
    assert tnet.protocol.senders == jnet.protocol.senders
    assert len(tnet.protocol.senders) == kw["msg_count"]
    adj = tnet.protocol.adj.numpy()
    assert adj.dtype == np.int32 and np.array_equal(adj, np.asarray(jnet.protocol.adj))
    assert_same_state(jax_numpy(jreplicate(jstate, 1)), state_to_numpy(treplicate(tstate, 1)),
                      f"{case}: initial state")
    want = jax_numpy(jnet.run_ms_batched(jreplicate(jstate, REPLICAS), SIM_MS))
    got = state_to_numpy(tnet.run_ms_batched(treplicate(tstate, REPLICAS), SIM_MS))
    assert_same_state(want, got, f"{case}: after {SIM_MS} ms")
    live = ~got["down"]
    assert (got["done_at"][live] > 0).all() and (got["dropped"] == 0).all()


def test_reference_defaults_replica_0():
    """The reference defaults to completion: replica 0 is the JAX
    package's seed-0 run (all 90 live nodes reached).  The run stops at
    the last node's done tick, 827, with 447 floods received of the 1013
    sent; without the stop the rest arrive, 885 in all."""
    jnet, jstate = jmake(JParams())
    tnet, tstate = tmake(TParams(), device="cpu")
    want = jax_numpy(jnet.run_ms_batched(jreplicate(jstate, REPLICAS), 5000, True))
    got = state_to_numpy(tnet.run_ms_batched(treplicate(tstate, REPLICAS), 5000, True))
    assert_same_state(want, got, "defaults, stop_when_done")
    live = ~got["down"][0]
    d = got["done_at"][0][live]
    assert live.sum() == 90 and (d > 0).all()
    assert np.percentile(d, [10, 50, 90]).tolist() == pytest.approx([332, 547.5, 736.1])
    assert d.max() == 827
    assert (int(got["msg_received"][0].sum()), int(got["msg_sent"][0].sum())) == (447, 1013)
