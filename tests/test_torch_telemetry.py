"""The telemetry side-car in the port against the JAX package.

Two contracts make the counters trustworthy, as in the JAX package's
tests/test_telemetry.py and tests/test_dropped_invariant.py:

  1. parity: with telemetry on, every `tele` leaf equals the JAX
     package's, and every other leaf equals the telemetry-off run's;
  2. reconciliation: the store counters balance per replica,
     sent == delivered + discarded + dropped + pending.

Here they hold for PingPong on the time wheel and the flat store,
batched P2PFlood with the snapshot ring (whose progress series
reproduces the host-side done-at CDF), PingPong under every fault lane,
`with_telemetry` on a mid-run state and `run_ms_occupancy`; the host
exports (`counters`, `progress_series`, Prometheus text, run records)
give the JAX package's output on equal states; the invariant holds on
seven protocols; and the SpanTracer cases of tests/test_trace.py run on
the port's copy.  Handel's cases are in test_torch_telemetry_handel.py.
Every leaf is integer or bool, so every comparison is exact.
"""

import json
import threading

import jax
import numpy as np
import pytest
import torch

from wittgenstein_tpu.engine import replicate_state as jreplicate
from wittgenstein_tpu.faults import FaultConfig as JFaultConfig
from wittgenstein_tpu.faults import FaultPlan as JPlan
from wittgenstein_tpu.protocols.p2pflood import P2PFloodParameters as JFloodParams
from wittgenstein_tpu.protocols.p2pflood_batched import make_p2pflood as jmake_flood
from wittgenstein_tpu.protocols.pingpong_batched import make_pingpong as jmake_pp
from wittgenstein_tpu.telemetry import TelemetryConfig as JConfig
from wittgenstein_tpu.telemetry import counters as jcounters
from wittgenstein_tpu.telemetry import progress_series as jprogress
from wittgenstein_tpu.telemetry import prometheus_from_counters as jprom
from wittgenstein_tpu_torch.engine import replicate_state as treplicate
from wittgenstein_tpu_torch.faults import FaultConfig as TFaultConfig
from wittgenstein_tpu_torch.faults import FaultPlan as TPlan
from wittgenstein_tpu_torch.interop import state_to_numpy
from wittgenstein_tpu_torch.protocols.avalanche_batched import make_slush
from wittgenstein_tpu_torch.protocols.gsf import GSFSignatureParameters
from wittgenstein_tpu_torch.protocols.gsf_batched import make_gsf
from wittgenstein_tpu_torch.protocols.handel import HandelParameters
from wittgenstein_tpu_torch.protocols.handel_batched import make_handel
from wittgenstein_tpu_torch.protocols.p2pflood import P2PFloodParameters as TFloodParams
from wittgenstein_tpu_torch.protocols.p2pflood_batched import make_p2pflood as tmake_flood
from wittgenstein_tpu_torch.protocols.p2phandel import P2PHandelParameters
from wittgenstein_tpu_torch.protocols.p2phandel_batched import make_p2phandel
from wittgenstein_tpu_torch.protocols.paxos_batched import make_paxos
from wittgenstein_tpu_torch.protocols.pingpong_batched import make_pingpong as tmake_pp
from wittgenstein_tpu_torch.telemetry import (
    PromText,
    RunRecordWriter,
    SpanTracer,
    TelemetryConfig,
    counters,
    done_counts_at,
    engine_phase_fns,
    maybe_span,
    pending_count,
    phase_means,
    progress_series,
    prometheus_from_counters,
    read_run_records,
    scan_phase_seconds,
    validate_chrome_trace,
)

CFG = dict(snapshots=64, snapshot_every_ms=10)
REPLICAS = 2
PP_NODES = 128
PP_MS = 400
FLOOD_MS = 800


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def jax_numpy(state) -> dict:
    """The JAX package's state as numpy leaves, side-cars as dicts."""
    d = jax.tree_util.tree_map(np.asarray, state)._asdict()
    d["proto"] = dict(d["proto"])
    for f in ("tele", "faults"):
        if d[f] != ():
            d[f] = d[f]._asdict()
    return d


def assert_same_state(want: dict, got: dict, tag: str, skip=()) -> None:
    """Every leaf (but the fields in `skip`) equal in name, dtype, shape
    and bits; proto and the side-cars leaf by leaf."""
    assert set(want) == set(got), tag
    for f, w in want.items():
        if f in skip:
            continue
        g = got[f]
        if isinstance(w, dict):
            assert set(w) == set(g), f"{tag}: {f} keys {sorted(set(w) ^ set(g))}"
            for k in w:
                assert w[k].dtype == g[k].dtype, f"{tag}: {f}.{k} dtype {g[k].dtype}"
                assert w[k].shape == g[k].shape, f"{tag}: {f}.{k} shape {g[k].shape}"
                assert np.array_equal(w[k], g[k]), f"{tag}: {f}.{k} differs"
        elif isinstance(w, np.ndarray):
            assert w.dtype == g.dtype and w.shape == g.shape, f"{tag}: {f} dtype/shape"
            assert np.array_equal(w, g), f"{tag}: {f} differs"
        else:
            assert g == w == (), f"{tag}: side-car {f}"


def assert_reconciles(got: dict) -> None:
    """sent == delivered + discarded + dropped + pending per replica, with
    the exact store census, and the per-mtype drops are the store's."""
    tele = got["tele"]
    sent, delivered, discarded, dropped = (tele[k].sum(-1) for k in (
        "sent", "delivered", "discarded", "dropped"))
    pending = got["msg_valid"].sum((-2, -1)) + got["ovf_valid"].sum(-1)
    np.testing.assert_array_equal(sent, delivered + discarded + dropped + pending)
    np.testing.assert_array_equal(dropped, got["dropped"])


_RUNS = {}


def _pingpong(wheel_rows):
    """PingPong x 2 x PP_MS with telemetry on both sides, and the port's
    telemetry-off run: (JAX net, JAX state, port net, port state, port
    plain state, port plain net), built once per store."""
    key = ("pingpong", wheel_rows)
    if key not in _RUNS:
        jnet, js = jmake_pp(PP_NODES, wheel_rows=wheel_rows, telemetry=JConfig(**CFG))
        tnet, ts = tmake_pp(PP_NODES, wheel_rows=wheel_rows, telemetry=TelemetryConfig(**CFG),
                            device="cpu")
        pnet, ps = tmake_pp(PP_NODES, wheel_rows=wheel_rows, device="cpu")
        jout = jnet.run_ms_batched(jreplicate(js, REPLICAS), PP_MS)
        tout = tnet.run_ms_batched(treplicate(ts, REPLICAS), PP_MS)
        pout = pnet.run_ms_batched(treplicate(ps, REPLICAS), PP_MS)
        _RUNS[key] = (jnet, jout, tnet, tout, pout, pnet)
    return _RUNS[key]


def _p2pflood():
    """P2PFlood at its defaults x 2 x FLOOD_MS on the flat store with a
    128-slot ring (the JAX package's fixture, cut from 1200 ms)."""
    if "p2pflood" not in _RUNS:
        cfg = dict(snapshots=128, snapshot_every_ms=10)
        jnet, js = jmake_flood(JFloodParams(), capacity=2048, telemetry=JConfig(**cfg))
        tnet, ts = tmake_flood(TFloodParams(), capacity=2048, telemetry=TelemetryConfig(**cfg),
                               device="cpu")
        pnet, ps = tmake_flood(TFloodParams(), capacity=2048, device="cpu")
        jout = jnet.run_ms_batched(jreplicate(js, REPLICAS), FLOOD_MS)
        tout = tnet.run_ms_batched(treplicate(ts, REPLICAS), FLOOD_MS)
        pout = pnet.run_ms_batched(treplicate(ps, REPLICAS), FLOOD_MS)
        _RUNS["p2pflood"] = (jnet, jout, tnet, tout, pout, pnet)
    return _RUNS["p2pflood"]


def _check_parity(run, tag):
    _, jout, _, tout, pout, _ = run
    want, got, plain = jax_numpy(jout), state_to_numpy(tout), state_to_numpy(pout)
    assert_same_state(want, got, tag)  # every leaf, tele included
    assert_same_state(plain, got, f"{tag} vs telemetry off", skip=("tele",))
    assert plain["tele"] == ()
    assert_reconciles(got)
    return got


@pytest.mark.parametrize("wheel_rows", [None, 0], ids=["wheel", "flat"])
def test_pingpong_tele_matches_jax(wheel_rows):
    run = _pingpong(wheel_rows)
    got = _check_parity(run, f"pingpong wheel_rows={wheel_rows}")
    tele = got["tele"]
    # the tick census is the loop's own count of each replica's ticks
    assert np.array_equal(tele["ticks"], run[2].jump_stats["ticks"].numpy())
    # every ping answered, nothing in flight; the jumps skipped empty ms
    assert (tele["sent"].sum(-1) == 2 * PP_NODES).all()
    assert (tele["jumps"] > 0).all()
    assert (tele["ticks"] + tele["jumped_ms"] <= PP_MS).all()


def test_p2pflood_ring_matches_jax_and_host_cdf():
    """The snapshot ring is sized to the horizon, so no window is lost to
    wrap: each replica's device-side progress series gives the done-at
    CDF computed on the host from the final done_at."""
    got = _check_parity(_p2pflood(), "p2pflood")
    tout = _p2pflood()[3]
    series = progress_series(tout)
    ends = [t + 9 for t in range(0, FLOOD_MS, 10)]
    for r in range(REPLICAS):
        done = got["done_at"][r]
        host = [int(((done > 0) & (done <= t)).sum()) for t in ends]
        assert done_counts_at(series[r], ends) == host, f"replica {r}"
    assert series[0][-1]["done"] > series[0][0]["done"]


def test_pingpong_under_every_fault_lane():
    """Telemetry beside the fault side-car: the fault-discarded rows are
    counted inside `discarded`, and every leaf equals the JAX package's."""
    from test_torch_faults import _lanes

    plan = _lanes(64)["all"]
    jnet, js = jmake_pp(64, telemetry=JConfig(**CFG))
    tnet, ts = tmake_pp(64, telemetry=TelemetryConfig(**CFG), device="cpu")
    jfnet, js = jnet.with_faults(jreplicate(js, REPLICAS), JFaultConfig(), plan(JPlan))
    tfnet, ts = tnet.with_faults(treplicate(ts, REPLICAS), TFaultConfig(), plan(TPlan))
    want = jax_numpy(jfnet.run_ms_batched(js, 300))
    got = state_to_numpy(tfnet.run_ms_batched(ts, 300))
    assert_same_state(want, got, "pingpong all lanes")
    assert_reconciles(got)
    assert got["tele"]["discarded"].sum() > 0 and got["tele"]["lat_filtered"].sum() > 0
    assert got["faults"]["dropped_by_fault"].sum() > 0


def test_with_telemetry_mid_run():
    """Instrumenting a state 50 ms into the run: `sent` starts at the
    store's census, so the invariant holds over the rest of the run."""
    jnet, js = jmake_pp(64)
    tnet, ts = tmake_pp(64, device="cpu")
    js = jnet.run_ms_batched(jreplicate(js, REPLICAS), 50)
    ts = tnet.run_ms_batched(treplicate(ts, REPLICAS), 50)
    jtnet, js = jnet.with_telemetry(js, JConfig(snapshots=8, snapshot_every_ms=25))
    ttnet, ts = tnet.with_telemetry(ts, TelemetryConfig(snapshots=8, snapshot_every_ms=25))
    census = state_to_numpy(ts)["tele"]["sent"]
    assert census.sum() > 0 and np.array_equal(census, np.asarray(js.tele.sent))
    want = jax_numpy(jtnet.run_ms_batched(js, 250))
    got = state_to_numpy(ttnet.run_ms_batched(ts, 250))
    assert_same_state(want, got, "with_telemetry at 50 ms")
    assert_reconciles(got)


def test_run_ms_occupancy_matches_jax():
    """The per-tick occupancy probe: each replica's high-water marks and
    final state equal the JAX package's single-replica run."""
    jnet, js = jmake_pp(64)
    tnet, ts = tmake_pp(64, device="cpu")
    out, marks = tnet.run_ms_occupancy(treplicate(ts, REPLICAS), 120)
    got = state_to_numpy(out)
    for r, jr in enumerate(jax.tree_util.tree_map(lambda a: a[r], jreplicate(js, REPLICAS))
                           for r in range(REPLICAS)):
        jout, jmarks = jnet.run_ms_occupancy(jr, 120)
        assert int(marks["wheel_fill_hwm"][r]) == int(jmarks["wheel_fill_hwm"]) > 0
        assert int(marks["overflow_hwm"][r]) == int(jmarks["overflow_hwm"])
        want = jax_numpy(jout)
        for f, w in want.items():
            g = got[f]
            if isinstance(w, dict):
                for k in w:
                    assert np.array_equal(w[k], g[k][r]), f"replica {r}: proto.{k}"
            elif isinstance(w, np.ndarray):
                assert np.array_equal(w, g[r]), f"replica {r}: {f}"


@pytest.mark.parametrize("run", ["pingpong", "p2pflood"])
def test_host_exports_match_jax(run, tmp_path):
    """counters, progress_series, Prometheus text and run records: the
    port's output on its state is the JAX package's on the equal state."""
    jnet, jout, tnet, tout, pout, pnet = _pingpong(None) if run == "pingpong" else _p2pflood()
    want, got = jcounters(jnet, jout), counters(tnet, tout)
    assert got == want
    plain = counters(pnet, pout)
    assert plain["telemetry_enabled"] is False and "loop" not in plain
    assert plain["node"] == got["node"] and plain["time"] == got["time"]
    assert pending_count(tout) == want["store"]["pending"]
    assert progress_series(tout) == jprogress(jout)
    assert progress_series(tout, replica=1) == jprogress(jout, replica=1)
    assert prometheus_from_counters(got) == jprom(want)
    path = str(tmp_path / "runs.jsonl")
    rec = RunRecordWriter(path).write(got, tag=run)
    back = read_run_records(path)
    assert back == [rec] and back[0]["store"] == json.loads(json.dumps(want["store"]))


# the store invariant on a parametrised set of protocols, instrumented
# with with_telemetry after their initial emissions: (build, ms)
INVARIANT = {
    "pingpong": (lambda: tmake_pp(256, device="cpu"), 900),
    "p2pflood": (lambda: tmake_flood(TFloodParams(), capacity=2048, device="cpu"), 2001),
    "paxos": (lambda: make_paxos(device="cpu"), 2000),
    "slush": (lambda: make_slush(device="cpu"), 600),
    "handel": (lambda: make_handel(HandelParameters(
        node_count=64, threshold=63, pairing_time=3, level_wait_time=50, extra_cycle=10,
        dissemination_period_ms=10, fast_path=10, nodes_down=0), device="cpu"), 250),
    "gsf": (lambda: make_gsf(GSFSignatureParameters(
        node_count=64, threshold=63, pairing_time=3, timeout_per_level_ms=50,
        period_duration_ms=10, accelerated_calls_count=10, nodes_down=0), device="cpu"), 250),
    "p2phandel": (lambda: make_p2phandel(P2PHandelParameters(
        signing_node_count=64, relaying_node_count=8, threshold=60, connection_count=12,
        pairing_time=20, sigs_send_period=200), device="cpu"), 400),
}


@pytest.mark.parametrize("name", list(INVARIANT))
def test_store_counters_reconcile(name):
    build, ms = INVARIANT[name]
    net, state = build()
    tnet, states = net.with_telemetry(treplicate(state, REPLICAS), TelemetryConfig())
    got = state_to_numpy(tnet.run_ms_batched(states, ms))
    assert_reconciles(got)
    tele = got["tele"]
    # traffic shows through the store or the latency path every channel
    # send crosses, and every replica executed ticks
    assert (tele["sent"].sum(-1) + tele["lat_sent"].sum(-1) > 0).all(), name
    assert (tele["ticks"] > 0).all(), name


def test_phase_seconds_on_the_engine():
    """scan_phase_seconds over engine_phase_fns: every phase timed, each
    pass a span, the states left untouched."""
    net, state = tmake_pp(32, device="cpu")
    states = treplicate(state, REPLICAS)
    before = state_to_numpy(states)
    tracer = SpanTracer("phases")
    stats = scan_phase_seconds(states, engine_phase_fns(net), scans=2, tracer=tracer,
                               repeats=2)
    assert set(stats) == {"full_step", "delivery", "deliver_apply", "protocol_tick", "beat"}
    for row in stats.values():
        assert row["scans"] == 2 and row["repeats"] == 2 and len(row["samples_s"]) == 2
        assert 0 < row["min_s"] <= row["mean_s"]
    assert set(phase_means(stats)) == set(stats)
    spans = [e for e in tracer.to_json()["traceEvents"] if e["ph"] == "X"]
    assert len(spans) == 5 * (2 + 2)
    assert_same_state(before, state_to_numpy(states), "states after timing")


# -- the SpanTracer cases of tests/test_trace.py, on the port's copy --------
def _events(tracer, ph=None, name=None):
    evs = tracer.to_json()["traceEvents"]
    return [e for e in evs if (ph is None or e["ph"] == ph) and (name is None or e["name"] == name)]


def test_trace_round_trip_and_schema(tmp_path):
    tracer = SpanTracer("roundtrip")
    with tracer.span("outer", stage=1):
        with tracer.span("inner"):
            pass
    tracer.instant("marker", chunk=0)
    path = tracer.write(str(tmp_path / "trace.json"))
    with open(path) as f:
        doc = json.load(f)
    validate_chrome_trace(doc)
    assert doc["displayTimeUnit"] == "ms"
    assert doc["traceEvents"] == tracer.to_json()["traceEvents"]
    meta = doc["traceEvents"][0]
    assert meta["ph"] == "M" and meta["args"]["name"] == "roundtrip"
    inner, outer = _events(tracer, "X", "inner")[0], _events(tracer, "X", "outer")[0]
    assert inner["tid"] == outer["tid"] and outer["ts"] <= inner["ts"]
    assert outer["ts"] + outer["dur"] >= inner["ts"] + inner["dur"]
    for bad in ({"events": []}, {"traceEvents": [{"ph": "X"}]},
                {"traceEvents": [{"ph": "X", "name": "x"}]}):
        with pytest.raises(ValueError):
            validate_chrome_trace(bad)


def test_trace_threads_exceptions_and_maybe_span():
    tracer = SpanTracer()
    with pytest.raises(RuntimeError):
        with tracer.span("doomed"):
            raise RuntimeError("boom")
    assert _events(tracer, "X", "doomed")

    def work():
        with tracer.span("thread-span"):
            pass

    t = threading.Thread(target=work)
    t.start()
    t.join()
    assert len({e["tid"] for e in _events(tracer, "X")}) == 2
    with maybe_span(None, "ignored"):
        pass
    with maybe_span(tracer, "real"):
        pass
    assert _events(tracer, "X", "real")


def test_trace_context_ids():
    class Ctx:
        def ids(self):
            return {"run_id": "run-test", "job_id": "j1", "tenant_id": "acme"}

    tracer = SpanTracer(ctx=Ctx())
    with tracer.span("chunk", index=3):
        pass
    tracer.instant("marker")
    for ev in (_events(tracer, "X")[0], _events(tracer, "i")[0]):
        assert ev["args"]["run_id"] == "run-test" and ev["args"]["tenant_id"] == "acme"
    assert _events(tracer, "X")[0]["args"]["index"] == 3
    later = SpanTracer(ctx={"run_id": "ctx-run"})
    with later.span("s", run_id="explicit"):
        pass
    assert _events(later, "X")[0]["args"]["run_id"] == "explicit"
    assert _events(later, "M", "trace_context")[0]["args"] == {"run_id": "ctx-run"}
    plain = SpanTracer()
    with plain.span("plain"):
        pass
    assert "args" not in _events(plain, "X")[0]


def test_promtext_escaping_and_run_records(tmp_path):
    text = PromText("x").add("m", 1, 'he said "hi"\nback\\slash',
                             labels={"k": 'v"\n\\'}).render()
    assert '\\"hi\\"' in text and "\\n" in text and "\\\\" in text
    assert 'x_m{k="v\\"\\n\\\\"} 1' in text
    path = str(tmp_path / "runs.jsonl")
    w = RunRecordWriter(path)
    rec1 = w.write({"a": np.int32(3), "arr": np.arange(3), "t": torch.arange(2)}, tag="one")
    rec2 = w.write({"b": 2.5}, tag="two")
    assert read_run_records(path) == [rec1, rec2]
    assert rec1["a"] == 3 and rec1["arr"] == [0, 1, 2] and rec1["t"] == [0, 1]
    with open(path, "a") as f:
        f.write('{"unterminated": ')
    assert read_run_records(path) == [rec1, rec2]
