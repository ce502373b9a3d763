"""Batches whose replicas' clocks differ on the time wheel, in the port
against the JAX package.

P2PHandel ticks every ms on the 512-row wheel and has no sparse beat, so
its batches run the ungated loop: the JAX package vmaps a per-replica
while_loop, the port runs each group of one clock on its own and freezes
each replica once it is done.  From a common start run 1150 ms, a batch
with clocks 1157, 1150 and 1157 runs 100 ms, and again 200 ms with
stop_when_done, during which every replica finishes (between 1206 and
1292 ms) and freezes; then `step` and `run_ms`.  Every leaf after each
run equals the JAX package's (test_torch_clocks.py has the helpers).
"""

import pytest
import torch

from test_torch_clocks import check_run, check_step, mixed_clocks
from wittgenstein_tpu.protocols.p2phandel import P2PHandelParameters as JParams
from wittgenstein_tpu.protocols.p2phandel_batched import make_p2phandel as jmake
from wittgenstein_tpu_torch.protocols.p2phandel import P2PHandelParameters as TParams
from wittgenstein_tpu_torch.protocols.p2phandel_batched import make_p2phandel as tmake

P2P = dict(signing_node_count=64, relaying_node_count=8, threshold=60, connection_count=12,
           pairing_time=20, sigs_send_period=200)
BASE_MS = 1150

_BUILT = {}


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


def p2phandel_wheel():
    if not _BUILT:
        jnet, jstate = jmake(JParams(**P2P))
        tnet, _ = tmake(TParams(**P2P), device="cpu")
        assert tnet.wheel_rows == 512 and tnet.protocol.BEAT_PERIOD is None
        _BUILT["p2p"] = (jnet, jstate, tnet, mixed_clocks(jnet, jstate, base_ms=BASE_MS))
    return _BUILT["p2p"]


def test_p2phandel_ungated_mixed_clocks():
    got = check_run(p2phandel_wheel(), 100, False, "p2phandel")
    assert got["time"].tolist() == [1257, 1250, 1257]


def test_p2phandel_ungated_mixed_clocks_stop_when_done():
    got = check_run(p2phandel_wheel(), 200, True, "p2phandel")
    assert (got["done_at"] > 0).all()


def test_p2phandel_step_on_mixed_clocks():
    check_step(p2phandel_wheel(), "p2phandel")
