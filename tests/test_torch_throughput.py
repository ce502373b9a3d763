"""The Mathis throughput model and the engine's throughput and discard-time
options in the port against the JAX package.

`MathisNetworkThroughput.delay` gives the JAX package's delays over node
pairs of the default builder and the reference's golden 117 and 1177 ms
(NetworkThroughputTest.java:21-36); `vec_delay` equals the JAX form bit
for bit over every latency up to 20000 ms and lies within its 1 ms of the
scalar form.  `BatchedNetwork(throughput=..., msg_discard_time=...)`:
the twin of the JAX package's engine-wiring test, then PingPong at 64
nodes with 4096-byte messages under the Mathis model and a discard time
that drops some sends and keeps others, every leaf equal to the JAX
package's, with and without the fault side-car's neutral schedule; the
cache keys hold both options in the JAX package's slots, and the state
digests are the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_paxos import assert_same_state, jax_numpy
from wittgenstein_tpu.core import latency as jlat
from wittgenstein_tpu.core.node import Node as JNode
from wittgenstein_tpu.core.registries import registry_node_builders as jbuilders
from wittgenstein_tpu.core.throughput import MathisNetworkThroughput as JMathis
from wittgenstein_tpu.engine import replicate_state as jreplicate
from wittgenstein_tpu.faults import FaultConfig as JConfig
from wittgenstein_tpu.protocols.pingpong_batched import make_pingpong as jmake
from wittgenstein_tpu.serve.scheduler import state_digest as jdigest
from wittgenstein_tpu.utils.javarand import JavaRandom as JRandom
from wittgenstein_tpu_torch.core import latency as tlat
from wittgenstein_tpu_torch.core.geo import MAX_X
from wittgenstein_tpu_torch.core.node import Node as TNode
from wittgenstein_tpu_torch.core.node import NodeBuilder
from wittgenstein_tpu_torch.core.registries import registry_node_builders as tbuilders
from wittgenstein_tpu_torch.core.throughput import MathisNetworkThroughput as TMathis
from wittgenstein_tpu_torch.core.throughput import NetworkThroughput
from wittgenstein_tpu_torch.engine import map_state
from wittgenstein_tpu_torch.engine.core import INT_MAX
from wittgenstein_tpu_torch.engine import replicate_state as treplicate
from wittgenstein_tpu_torch.engine.rng import hash32, pseudo_delta
from wittgenstein_tpu_torch.faults import FaultConfig as TConfig
from wittgenstein_tpu_torch.interop import state_to_numpy
from wittgenstein_tpu_torch.protocols.pingpong_batched import make_pingpong as tmake
from wittgenstein_tpu_torch.serve.scheduler import state_digest as tdigest
from wittgenstein_tpu_torch.utils.javarand import JavaRandom as TRandom

N = 64
SIZE = 4096
WINDOW = 64 * 1024
# the first hop's median latency under the Mathis model at 4096 bytes is
# ~104 ms, so 120 drops about 40% of the sends and keeps the rest
DISCARD_MS = 120
SIM_MS = 500


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


class _HalfMap(NodeBuilder):
    """x advances by MAX_X / 2 a node: the reference test's fixture."""

    def __init__(self):
        super().__init__()
        self._ai = 1

    def get_x(self, rd_int):
        v = self._ai
        self._ai += MAX_X // 2
        return v


def test_delay_goldens():
    """The reference's NetworkThroughputTest: 117 ms under the TCP window
    limit, 1177 under the bandwidth limit, and the raw latency below one
    MSS."""
    nb = _HalfMap()
    n1, n2 = TNode(TRandom(0), nb), TNode(TRandom(0), nb)
    assert TMathis(tlat.NetworkFixedLatency(100), 64 * 1024).delay(n1, n2, 0, 2048) == 117
    assert TMathis(tlat.NetworkFixedLatency(1000), 5 * 1024 * 1024).delay(n1, n2, 0, 2048) == 1177
    assert TMathis(tlat.NetworkFixedLatency(100), 64 * 1024).delay(n1, n2, 0, 100) == 100
    with pytest.raises(NotImplementedError):
        NetworkThroughput().delay(n1, n2, 0, 2048)


@pytest.mark.parametrize("size", [100, 1460, 2048, 4096, 65536])
def test_delay_matches_jax(size):
    """Every pair of 30 default-builder nodes at every tenth delta, priced
    off the constructor's model and off another `nl`."""
    jrd, trd = JRandom(3), TRandom(3)
    jnb, tnb = jbuilders.get_by_name(None), tbuilders.get_by_name(None)
    jn = [JNode(jrd, jnb) for _ in range(30)]
    tn = [TNode(trd, tnb) for _ in range(30)]
    jm = JMathis(jlat.NetworkLatencyByDistanceWJitter(), WINDOW)
    tm = TMathis(tlat.NetworkLatencyByDistanceWJitter(), WINDOW)
    jic3, tic3 = jlat.IC3NetworkLatency(), tlat.IC3NetworkLatency()
    for i in range(30):
        for j in range(30):
            for d in range(0, 100, 10):
                assert tm.delay(tn[i], tn[j], d, size) == jm.delay(jn[i], jn[j], d, size)
                assert tm.delay(tn[i], tn[j], d, size, nl=tic3) == \
                    jm.delay(jn[i], jn[j], d, size, nl=jic3)


@pytest.mark.parametrize("window", [64 * 1024, 5 * 1024 * 1024])
def test_vec_delay_matches_jax(window):
    """Latencies 1..20000 ms (a fixed 1 ms model plus each node's extra
    latency) at sizes below, at and above one MSS, given as an int and as
    a tensor: the JAX form's float32 bits, and within 1 ms of the scalar
    form."""
    n = 20001
    extra = np.arange(n, dtype=np.int32)
    ones = np.ones(n, np.int32)
    frm, to = np.zeros(n - 1, np.int32), np.arange(1, n, dtype=np.int32)
    delta = np.zeros(n - 1, np.int32)
    jstatic = jlat.LatencyStatic(ones, ones, extra)
    tstatic = tlat.LatencyStatic(*(torch.from_numpy(a)[None] for a in (ones, ones, extra)))
    jm = JMathis(jlat.NetworkFixedLatency(1), window)
    tm = TMathis(tlat.NetworkFixedLatency(1), window)
    t_args = [torch.from_numpy(a)[None] for a in (frm, to, delta)]
    for size in (100, 1459, 1460, 2048, 4096, 65536, 1_000_000):
        want = np.asarray(jm.vec_delay(jstatic, jnp.asarray(frm), jnp.asarray(to),
                                       jnp.asarray(delta), jnp.full(n - 1, size, jnp.int32)))
        got = tm.vec_delay(tstatic, *t_args, size)
        sized = tm.vec_delay(tstatic, *t_args, torch.full((1, n - 1), size, dtype=torch.int32))
        assert got.dtype == sized.dtype == torch.int32
        assert np.array_equal(got.numpy()[0], want) and np.array_equal(sized.numpy()[0], want)
        st = extra[1:] + 1
        scalar = np.array([_scalar(tm, int(s), size) for s in st[::97]])
        assert np.abs(want[::97] - scalar).max() <= 1


def _scalar(model, st: int, size: int) -> int:
    """delay() with a latency of st ms."""
    return TMathis(tlat.NetworkFixedLatency(st), model.window_size // 8).delay(
        _Pt(0), _Pt(1), 0, size)


class _Pt:
    def __init__(self, i):
        self.node_id, self.extra_latency = i, 0


def _sized(net, size):
    """Every message type of `net` at `size` bytes, on both of the
    engine's copies of the sizes."""
    if hasattr(net, "_msg_sizes_host"):
        net._msg_sizes_host[:] = size
        net._msg_sizes.fill_(size)
    else:
        net._msg_sizes = np.full(len(net._msg_sizes), size, np.int32)
    return net


def test_batched_engine_wiring():
    """The twin of the JAX package's test: PingPong 64 under
    NetworkFixedLatency(100) with 4096-byte messages; the Mathis delay
    reaches the arrivals, equal to the JAX package's and within 1 ms of
    the scalar form at each row's delta."""
    name = "NetworkFixedLatency(100)"
    jnet, jstate = jmake(N, network_latency_name=name)
    tnet, tstate = tmake(N, network_latency_name=name, device="cpu")
    jnet.throughput = JMathis(jnet.latency, WINDOW)
    tnet.throughput = TMathis(tnet.latency, WINDOW)
    _sized(jnet, SIZE), _sized(tnet, SIZE)
    frm, to = np.zeros(4, np.int32), np.arange(1, 5, dtype=np.int32)
    _, jok, jarr = jnet.latency_arrivals(jstate, jnp.ones(4, bool), jnp.asarray(frm),
                                         jnp.asarray(to), jstate.time + 1, 0)
    ts = treplicate(tstate, 1)
    t0 = int(ts.time[0])
    _, tok, tarr = tnet.latency_arrivals(ts, torch.ones((1, 4), dtype=torch.bool),
                                         torch.from_numpy(frm), torch.from_numpy(to),
                                         t0 + 1, 0, t0)
    assert bool(tok.all()) and np.array_equal(tarr.numpy()[0], np.asarray(jarr))
    lat = tarr.numpy()[0] - (t0 + 1)
    assert (lat > 100).all()
    seed = hash32(ts.seed[:, None], t0 + 1, torch.from_numpy(frm), 0, ts.send_ctr[:, None] + 1,
                  torch.from_numpy(to))
    deltas = pseudo_delta(torch.from_numpy(to), seed).numpy()[0]
    rd, nb = TRandom(0), tbuilders.get_by_name(None)
    nodes = [TNode(rd, nb) for _ in range(5)]
    scalar = TMathis(tnet.latency, WINDOW)
    for k in range(4):
        want = scalar.delay(nodes[0], nodes[int(to[k])], int(deltas[k]), SIZE)
        assert abs(int(lat[k]) - want) <= 1, (k, int(lat[k]), want)


def _throughput_nets():
    """PingPong 64 on both sides with 4096-byte messages, the Mathis model
    on the network's own latency model and DISCARD_MS."""
    jnet, jstate = jmake(N)
    tnet, tstate = tmake(N, device="cpu")
    for net, mathis in ((jnet, JMathis), (tnet, TMathis)):
        _sized(net, SIZE)
        net.throughput = mathis(net.latency, WINDOW)
        net.msg_discard_time = DISCARD_MS
    return jnet, jreplicate(jstate, 2), tnet, treplicate(tstate, 2)


@pytest.fixture(scope="module")
def runs():
    """Both sides' states after SIM_MS, plain and with the fault side-car's
    neutral schedule."""
    jnet, js, tnet, ts = _throughput_nets()
    out = {"nets": (jnet, tnet)}
    out["plain"] = (jnet.run_ms_batched(js, SIM_MS), tnet.run_ms_batched(ts, SIM_MS))
    jfnet, jfs = jnet.with_faults(js, JConfig())
    tfnet, tfs = tnet.with_faults(ts, TConfig())
    out["faults"] = (jfnet.run_ms_batched(jfs, SIM_MS), tfnet.run_ms_batched(tfs, SIM_MS))
    out["fault_nets"] = (jfnet, tfnet)
    return out


@pytest.mark.parametrize("arm", ["plain", "faults"])
def test_throughput_run_matches_jax(runs, arm):
    want, got = runs[arm]
    assert_same_state(jax_numpy(want), state_to_numpy(got), arm)
    pongs = got.proto["pong"].sum(-1)
    # the discard time bites: some pings or pongs never arrive
    assert (pongs > 0).all() and (pongs < N).all()
    assert (got.msg_sent.sum(-1) > got.msg_received.sum(-1)).all()
    for r in range(2):
        row = map_state(lambda a: a[r], got)
        assert tdigest(row) == jdigest(jax_numpy_row(want, r))


def jax_numpy_row(state, r):
    import jax

    return jax.tree_util.tree_map(lambda a: a[r], state)


def test_neutral_schedule_equals_plain(runs):
    """In the port itself: the neutral schedule gives the plain run's
    leaves."""
    plain = state_to_numpy(runs["plain"][1])
    armed = state_to_numpy(runs["faults"][1])
    assert plain.pop("faults") == ()
    armed.pop("faults")
    assert_same_state(plain, armed, "neutral")


def test_cache_keys_hold_both_options(runs):
    """The discard time and the throughput model's class name sit in the
    JAX package's slots 8 and 9 of stable_cache_key; a network that differs
    only there has another key."""
    for jnet, tnet in (runs["nets"], runs["fault_nets"]):
        jkey, tkey = jnet.stable_cache_key(), tnet.stable_cache_key()
        assert tkey[:10] == jkey[:10]
        assert tkey[8:10] == (DISCARD_MS, "MathisNetworkThroughput")
        assert tkey[10:14] == (jkey[11], jkey[12], jkey[15], jkey[16])
    bare, _ = tmake(N, device="cpu")
    assert bare.stable_cache_key()[8:10] == (INT_MAX, None)
    tnet = runs["nets"][1]
    assert bare.cache_key() != tnet.cache_key()
    assert tnet.cache_key()[:2] + tnet.cache_key()[4:] == tnet.stable_cache_key()
