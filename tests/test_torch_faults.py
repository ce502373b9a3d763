"""The fault side-car in the port against the JAX package.

A FaultPlan lowers to the same FaultState leaves and the same digest on
both sides, and every plan-validation error raises the same
FaultPlanError.  Each lane alone, then all lanes together, runs on
PingPong on the time wheel, on P2PFlood on the flat store, and on Handel
at 64 nodes (silence and crash, through the latency path every channel
send crosses); every leaf after the run equals the JAX package's, the
fault counters included.  Paxos sends four emissions a tick through one
call of the send path, so its drop run pins each row's own emission
counter in the drop draw.  In the port itself, the neutral schedule
gives the fault-free run bit for bit.
"""

import numpy as np
import pytest
import torch

from test_torch_paxos import assert_same_state, jax_numpy
from wittgenstein_tpu.engine import replicate_state as jreplicate
from wittgenstein_tpu.faults import FaultConfig as JConfig
from wittgenstein_tpu.faults import FaultPlan as JPlan
from wittgenstein_tpu.faults import FaultPlanError as JPlanError
from wittgenstein_tpu.faults import fault_state_digest as jdigest
from wittgenstein_tpu.faults import lower_plans as jlower_plans
from wittgenstein_tpu.protocols.handel import HandelParameters as JHandelParams
from wittgenstein_tpu.protocols.handel_batched import make_handel as jmake_handel
from wittgenstein_tpu.protocols.p2pflood import P2PFloodParameters as JFloodParams
from wittgenstein_tpu.protocols.p2pflood_batched import make_p2pflood as jmake_flood
from wittgenstein_tpu.protocols.paxos_batched import make_paxos as jmake_paxos
from wittgenstein_tpu.protocols.pingpong_batched import make_pingpong as jmake_pp
from wittgenstein_tpu_torch.engine import BatchedNetwork
from wittgenstein_tpu_torch.engine import replicate_state as treplicate
from wittgenstein_tpu_torch.faults import FaultConfig as TConfig
from wittgenstein_tpu_torch.faults import FaultPlan as TPlan
from wittgenstein_tpu_torch.faults import FaultPlanError as TPlanError
from wittgenstein_tpu_torch.faults import fault_state_digest as tdigest
from wittgenstein_tpu_torch.faults import lower_plans as tlower_plans
from wittgenstein_tpu_torch.faults import plan_digest as tplan_digest
from wittgenstein_tpu_torch.interop import state_to_numpy
from wittgenstein_tpu_torch.protocols.handel import HandelParameters as THandelParams
from wittgenstein_tpu_torch.protocols.handel_batched import make_handel as tmake_handel
from wittgenstein_tpu_torch.protocols.p2pflood import P2PFloodParameters as TFloodParams
from wittgenstein_tpu_torch.protocols.p2pflood_batched import make_p2pflood as tmake_flood
from wittgenstein_tpu_torch.protocols.paxos_batched import make_paxos as tmake_paxos
from wittgenstein_tpu_torch.protocols.pingpong_batched import make_pingpong as tmake_pp

REPLICAS = 2


def _lanes(n: int) -> dict:
    """Plan builders (called with the FaultPlan class of either package):
    each lane alone, then all together, sized for n nodes."""
    groups = (np.arange(n) >= n // 2).astype(np.int32)
    crashed = list(range(1, n, 7))
    return {
        "crash": lambda P: P("crash").crash(crashed, at=40, recover=160),
        "crash_forever": lambda P: P("crash_forever").crash(crashed[:2], at=0),
        "partition": lambda P: P("partition").partition(groups, start=20, end=180),
        "drop": lambda P: P("drop").drop(300, start=10),
        "drop_one_type": lambda P: P("drop_one_type").drop(1000, mtypes=[0], start=0, end=150),
        "inflate": lambda P: P("inflate").inflate(1500, add_ms=3, start=5, end=200),
        "silence": lambda P: P("silence").silence([0, n - 1], start=30),
        "delay": lambda P: P("delay").delay([2, 3], 40, start=0, end=120),
        "all": lambda P: (P("all").crash(crashed, at=40, recover=160)
                          .partition(groups, start=20, end=180).drop(50, start=0)
                          .inflate(1500, start=0).silence([5], start=10, end=150)
                          .delay([6], 25, start=10, end=150)),
    }


PP_NODES = 64
PP_LANES = _lanes(PP_NODES)


_ARMED = {}


def _armed(key, jbuild, tbuild):
    """Both sides' engines armed with FaultConfig(), built once per path:
    a plan is data, so every plan of a path reuses the JAX package's one
    compiled program."""
    if key not in _ARMED:
        jnet, jstate = jbuild()
        tnet, tstate = tbuild()
        jfnet, _ = jnet.with_faults(jstate, JConfig())
        tfnet, _ = tnet.with_faults(tstate, TConfig())
        _ARMED[key] = (jfnet, jreplicate(jstate, REPLICAS), tfnet, treplicate(tstate, REPLICAS))
    return _ARMED[key]


def _run_both(key, jbuild, tbuild, plan, ms):
    """Arm the plan (a builder of FaultPlan, or None for the neutral
    schedule) on 2 replicas of both sides, run `ms`; both as numpy
    leaves."""
    jfnet, js, tfnet, ts = _armed(key, jbuild, tbuild)
    jplan = None if plan is None else plan(JPlan)
    tplan = None if plan is None else plan(TPlan)
    _, js = jfnet.with_faults(js, JConfig(), jplan)
    _, ts = tfnet.with_faults(ts, TConfig(), tplan)
    want = jax_numpy(jfnet.run_ms_batched(js, ms))
    got = state_to_numpy(tfnet.run_ms_batched(ts, ms))
    return want, got


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


@pytest.mark.parametrize("lane", list(PP_LANES))
def test_lower_and_digest_match_jax(lane):
    want = PP_LANES[lane](JPlan).lower(PP_NODES, 3)
    got = PP_LANES[lane](TPlan).lower(PP_NODES, 3, device="cpu")
    for name, w, g in zip(want._fields, want, got):
        w = np.asarray(w)
        g = g.numpy()
        assert w.dtype == g.dtype and w.shape == g.shape and np.array_equal(w, g), name
    assert tdigest(got) == jdigest(want)
    assert tplan_digest(PP_LANES[lane](TPlan), PP_NODES, 3) == jdigest(want)
    assert PP_LANES[lane](TPlan).describe() == PP_LANES[lane](JPlan).describe()


def test_lower_plans_stacks_the_control_row():
    plans = [None, PP_LANES["all"]]
    want = jlower_plans([p and p(JPlan) for p in plans], PP_NODES, 2)
    got = tlower_plans([p and p(TPlan) for p in plans], PP_NODES, 2, device="cpu")
    for name, w, g in zip(want._fields, want, got):
        assert np.array_equal(np.asarray(w), g.numpy()) and g.shape[0] == 2, name
    assert tdigest(got) == jdigest(want)


BAD_PLANS = {
    "reversed_crash": lambda P: P("rev").crash([1], at=500, recover=200),
    "empty_crash": lambda P: P("empty").crash([1], at=300, recover=300),
    "negative_start": lambda P: P("neg").silence([0], start=-1),
    "reversed_partition": lambda P: P("rev").partition(np.zeros(8), start=9, end=3),
    "drop_rate": lambda P: P("rate").drop(1001),
    "inflate_negative": lambda P: P("neg").inflate(-1),
    "delay_negative": lambda P: P("neg").delay([1], -5),
    "drop_twice": lambda P: P("twice").drop(5).drop(6),
    "partition_twice": lambda P: P("twice").partition(np.zeros(8), 0).partition(np.zeros(8), 0),
    "inflate_twice": lambda P: P("twice").inflate(1000).inflate(1000),
    "silence_twice": lambda P: P("twice").silence([1]).silence([2]),
    "delay_twice": lambda P: P("twice").delay([1], 1).delay([1], 2),
}
BAD_LOWERS = {
    "crash_node": lambda P: P("out").crash([8], at=0),
    "silence_node": lambda P: P("out").silence([-1]),
    "delay_node": lambda P: P("out").delay([9], 3),
    "partition_shape": lambda P: P("shape").partition(np.zeros(7), 0),
    "drop_mtype": lambda P: P("mt").drop(5, mtypes=[2]),
    "inflate_mtype": lambda P: P("mt").inflate(2000, mtypes=[-1]),
    "byz_windows": lambda P: P("win").silence([1], start=0, end=9).delay([2], 1, start=0),
}


@pytest.mark.parametrize("case", list(BAD_PLANS) + list(BAD_LOWERS))
def test_plan_errors_match_jax(case):
    """Each invalid plan raises FaultPlanError (a ValueError) with the JAX
    package's message, when it is built or when it is lowered."""
    build = BAD_PLANS.get(case) or BAD_LOWERS[case]
    messages = []
    for plan_cls, err, lower in ((JPlan, JPlanError, lambda p: p.lower(8, 2)),
                                 (TPlan, TPlanError, lambda p: p.lower(8, 2, device="cpu"))):
        with pytest.raises(err) as info:
            lower(build(plan_cls))
        assert isinstance(info.value, ValueError)
        messages.append(str(info.value))
    assert messages[0] == messages[1]


def test_config_checks():
    with pytest.raises(ValueError, match="every lane disabled"):
        TConfig(False, False, False, False, False)
    assert TConfig(drops=False).key() == JConfig(drops=False).key()
    net, _ = tmake_pp(16, device="cpu")
    with pytest.raises(TypeError, match="FaultConfig"):
        BatchedNetwork(net.protocol, net.latency, 16, device="cpu", faults=object())
    # an engine built with a FaultConfig carries the neutral schedule
    fnet = BatchedNetwork(net.protocol, net.latency, 16, device="cpu", faults=TConfig())
    fs = fnet.init_state({"x": np.ones(16), "y": np.ones(16), "extra_latency": np.zeros(16)},
                         0, net.protocol.proto_init(16, device="cpu")).faults
    assert tdigest(fs) == tplan_digest(None, 16, net.protocol.n_msg_types())


@pytest.mark.parametrize("lane", list(PP_LANES))
def test_pingpong_wheel_lane(lane):
    want, got = _run_both("pingpong", lambda: jmake_pp(PP_NODES),
                          lambda: tmake_pp(PP_NODES, device="cpu"), PP_LANES[lane], 300)
    assert_same_state(want, got, f"pingpong {lane}")
    f = got["faults"]
    if lane in ("drop", "crash", "partition", "silence", "all", "crash_forever"):
        assert f["dropped_by_fault"].sum() > 0, lane
    if lane in ("inflate", "delay", "all"):
        assert f["delayed_by_fault"].sum() > 0, lane


def test_pingpong_heterogeneous_replicas():
    """lower_plans gives each replica its own schedule: a control row and
    the all-lanes row in one run."""
    jfnet, js, tfnet, ts = _armed("pingpong", lambda: jmake_pp(PP_NODES),
                                  lambda: tmake_pp(PP_NODES, device="cpu"))
    plans = [None, PP_LANES["all"]]
    jfs = jlower_plans([p and p(JPlan) for p in plans], PP_NODES, jfnet.protocol.n_msg_types())
    tfs = tlower_plans([p and p(TPlan) for p in plans], PP_NODES, tfnet.protocol.n_msg_types(),
                       device="cpu")
    _, js = jfnet.with_faults(js, JConfig(), jfs)
    _, ts = tfnet.with_faults(ts, TConfig(), tfs)
    want = jax_numpy(jfnet.run_ms_batched(js, 300))
    got = state_to_numpy(tfnet.run_ms_batched(ts, 300))
    assert_same_state(want, got, "pingpong control + all lanes")
    assert got["faults"]["dropped_by_fault"][0].sum() == 0
    assert got["faults"]["dropped_by_fault"][1].sum() > 0


FLOOD_NODES = 100
FLOOD_LANES = _lanes(FLOOD_NODES)


@pytest.mark.parametrize("lane", list(FLOOD_LANES))
def test_p2pflood_flat_lane(lane):
    want, got = _run_both("p2pflood", lambda: jmake_flood(JFloodParams(msg_count=3)),
                          lambda: tmake_flood(TFloodParams(msg_count=3), device="cpu"),
                          FLOOD_LANES[lane], 600)
    assert_same_state(want, got, f"p2pflood {lane}")


HANDEL_NODES = 64
HANDEL_LANES = {
    "silence": lambda P: P("silence").silence(list(range(51, 64)), start=0),
    "crash": lambda P: P("crash").crash(list(range(0, 64, 5)), at=60, recover=200),
    "silence_crash": lambda P: (P("silence_crash").silence([7, 8, 9], start=20, end=250)
                                .crash([1, 2], at=0)),
}


@pytest.mark.parametrize("lane", list(HANDEL_LANES))
def test_handel_lane(lane):
    """Handel's channel sends cross the latency path, so silence and crash
    act there in both packages; 64 nodes x 2 x 300 ms."""
    want, got = _run_both(
        "handel", lambda: jmake_handel(JHandelParams(node_count=HANDEL_NODES), score_cache=True),
        lambda: tmake_handel(THandelParams(node_count=HANDEL_NODES), score_cache=True,
                             device="cpu"),
        HANDEL_LANES[lane], 300)
    assert_same_state(want, got, f"handel {lane}")
    assert got["faults"]["dropped_by_fault"].sum() > 0


def test_paxos_drop_per_row_counter():
    """Paxos's ticks send four emissions through one send-path call; each
    row's drop draw must hash its own emission's counter."""
    plan = lambda P: P("drop").drop(400, start=0).inflate(1200, start=100, end=900)  # noqa: E731
    want, got = _run_both("paxos", jmake_paxos, lambda: tmake_paxos(device="cpu"), plan, 2000)
    assert_same_state(want, got, "paxos drop")
    assert got["faults"]["dropped_by_fault"].sum() > 0


def _without_faults(d: dict) -> dict:
    return {k: v for k, v in d.items() if k != "faults"}


@pytest.mark.parametrize("path", ["pingpong", "p2pflood", "handel"])
def test_neutral_schedule_is_the_fault_free_run(path):
    """In the port itself: armed with the neutral schedule, every other
    leaf equals the run without faults, and the counters stay 0."""
    make, ms = {
        "pingpong": (lambda: tmake_pp(PP_NODES, device="cpu"), 300),
        "p2pflood": (lambda: tmake_flood(TFloodParams(msg_count=3), device="cpu"), 600),
        "handel": (lambda: tmake_handel(THandelParams(node_count=HANDEL_NODES),
                                        score_cache=True, device="cpu"), 300),
    }[path]
    net, state = make()
    states = treplicate(state, REPLICAS)
    plain = state_to_numpy(net.run_ms_batched(states, ms))
    fnet, fstates = net.with_faults(states, TConfig())
    armed = state_to_numpy(fnet.run_ms_batched(fstates, ms))
    assert plain["faults"] == ()
    assert_same_state(_without_faults(plain), _without_faults(armed), f"{path} neutral")
    assert not armed["faults"]["dropped_by_fault"].any()
    assert not armed["faults"]["delayed_by_fault"].any()
