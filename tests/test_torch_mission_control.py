"""The port's chunk-boundary monitors against the JAX package's.

`TimeSeriesStore` under a fake clock answers every query as the JAX
package's store does and snapshots to the same JSON, which rides the
checkpoint manifest across the packages; `InvariantSentinel` raises the
JAX package's alerts on healthy, dropping, saturated and broken-store
states (PingPong and P2PFlood with telemetry, supervised) and never
raises on garbage; arming both leaves a supervised run's state
unchanged; `engine/capacity` gives the JAX package's answers over every
entry of the table, whose copy in the port is the root file byte for
byte; `attribution` gives the JAX package's rows and shares.
"""

import dataclasses
import filecmp
import json
import os

import jax
import numpy as np
import pytest
import torch

from test_torch_supervisor import jtree, same_tree
from wittgenstein_tpu import obs as jobs
from wittgenstein_tpu import runtime as jrt
from wittgenstein_tpu.engine import capacity as jcap
from wittgenstein_tpu.engine import replicate_state as jreplicate
from wittgenstein_tpu.telemetry.state import TelemetryConfig as JTele
from wittgenstein_tpu_torch import obs as tobs
from wittgenstein_tpu_torch import runtime as trt
from wittgenstein_tpu_torch.engine import capacity as tcap
from wittgenstein_tpu_torch.engine import replicate_state
from wittgenstein_tpu_torch.interop import state_to_numpy
from wittgenstein_tpu_torch.telemetry import TelemetryConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


# -- the time series -----------------------------------------------------------


def _drive(mod, ctx_run):
    """One scripted history through a package's store; every query's
    answer along the way, and the store."""
    clock = FakeClock()
    ts = mod.TimeSeriesStore(capacity=6, clock=clock)
    answers = []
    script = [(0.0, "inc", "err", 1.0), (10.0, "inc", "err", 2.0), (11.0, "observe", "lat", 100.0),
              (12.0, "observe", "lat", 1.0), (12.5, "observe", "lat", 2.0),
              (13.0, "inc", "err", 1.0), (9.0, "observe", "lat", 3.0), (20.0, "inc", "err", 0.5)]
    for i, (t, op, name, v) in enumerate(script):
        clock.t = t
        ctx = ctx_run if i % 3 == 0 else ({"run_id": f"r{i}"} if i % 3 == 1 else None)
        getattr(ts, op)(name, v, ctx=ctx)
        for w in (None, 1.0, 5.0, 15.0):
            now = t + 0.5
            answers.append((ts.count(name, w, now), ts.values(name, w, now),
                            ts.latest_ctx(name, w, now), ts.last(name)))
            if w:
                answers.append((ts.delta("err", w, now), ts.rate("err", w, now),
                                ts.quantile("lat", 0.5, w, now), ts.mean("lat", w, now)))
    for _ in range(10):  # past the ring's capacity
        clock.t += 1.0
        ts.observe("g", clock.t)
    answers.append((ts.names(), ts.summary(), ts.values("g")))
    return answers, ts


def test_timeseries_answers_equal_jax():
    jctx = jobs.TraceContext(run_id="victim-1", tenant_id="acme")
    tctx = tobs.TraceContext(run_id="victim-1", tenant_id="acme")
    ja, jts = _drive(jobs, jctx)
    ta, tts = _drive(tobs, tctx)
    assert ta == ja
    for n in (64, 3, 1):
        assert json.dumps(tts.snapshot(n), sort_keys=True) == json.dumps(jts.snapshot(n),
                                                                        sort_keys=True)


def test_timeseries_snapshots_cross_the_packages():
    _, jts = _drive(jobs, None)
    _, tts = _drive(tobs, None)
    for src, dst_mod in ((jts, tobs), (tts, jobs)):
        fresh = dst_mod.TimeSeriesStore(capacity=6)
        fresh.restore(json.loads(json.dumps(src.snapshot())))
        assert json.dumps(fresh.snapshot()) == json.dumps(src.snapshot())
        fresh.inc("err", 1.0, ts=100.0)
        assert fresh.last("err") == src.last("err") + 1.0


@pytest.mark.parametrize("mod", [jobs, tobs], ids=["jax", "torch"])
def test_timeseries_contract(mod):
    """The JAX package's store tests, on both stores."""
    ts = mod.TimeSeriesStore(capacity=4)
    for i in range(10):
        ts.observe("g", float(i))
    assert ts.values("g") == [6.0, 7.0, 8.0, 9.0]
    with pytest.raises(ValueError):
        ts.inc("g")
    with pytest.raises(ValueError):
        mod.TimeSeriesStore(capacity=0)
    with pytest.raises(ValueError):
        ts.rate("g", 0.0)
    ts2 = mod.TimeSeriesStore()
    ts2.observe("m", 1.0, ts=100.0)
    ts2.observe("m", 2.0, ts=50.0)  # the clock stepped back
    with ts2._lock:
        assert [t for t, _, _ in ts2._series["m"].samples] == [100.0, 100.0]
    old = mod.TimeSeriesStore()
    old.inc("e", 1.0, ts=50.0)
    live = mod.TimeSeriesStore()
    live.inc("e", 1.0, ts=60.0)
    live.inc("e", 1.0, ts=70.0)
    live.restore(old.snapshot())  # older: ignored
    assert live.count("e") == 2
    live.restore({"schema": "other"})
    live.restore(None)
    assert live.last("e") == 2.0


# -- the sentinel ----------------------------------------------------------------


TELE = dict(snapshots=2, snapshot_every_ms=20)


def _build(pkg: str, protocol: str):
    if pkg == "jax":
        from wittgenstein_tpu.protocols.p2pflood import P2PFloodParameters
        from wittgenstein_tpu.protocols.p2pflood_batched import make_p2pflood
        from wittgenstein_tpu.protocols.pingpong_batched import make_pingpong

        kw, tele = {}, JTele(**TELE)
    else:
        from wittgenstein_tpu_torch.protocols.p2pflood import P2PFloodParameters
        from wittgenstein_tpu_torch.protocols.p2pflood_batched import make_p2pflood
        from wittgenstein_tpu_torch.protocols.pingpong_batched import make_pingpong

        kw, tele = {"device": "cpu"}, TelemetryConfig(**TELE)
    if protocol == "PingPong":
        return make_pingpong(32, telemetry=tele, **kw)
    return make_p2pflood(P2PFloodParameters(node_count=40), telemetry=tele, **kw)


@pytest.fixture(scope="module")
def finals():
    """Each package's supervised 40-ms run (2 chunks) of PingPong (R=2)
    and P2PFlood (R=3), with telemetry."""
    out = {}
    for protocol, r in (("PingPong", 2), ("P2PFlood", 3)):
        jnet, js = _build("jax", protocol)
        tnet, ts = _build("torch", protocol)
        jrep = jrt.Supervisor.from_network(jnet, jreplicate(js, r), total_ms=40, chunk_ms=20).run()
        trep = trt.Supervisor.from_network(tnet, replicate_state(ts, r), total_ms=40,
                                           chunk_ms=20).run()
        same_tree(jtree(jrep.state), state_to_numpy(trep.state))
        out[protocol] = (jnet, jrep.state, tnet, trep.state)
    return out


def _events(rec):
    return [{k: v for k, v in e.items() if k not in ("ts", "seq")} for e in rec.events()]


def _both_sentinels(finals, protocol, forge=None, table=None, **check_kw):
    """The same check through each package's sentinel (recorder only);
    the findings, violations and events must be equal."""
    jnet, jfinal, tnet, tfinal = finals[protocol]
    if forge is not None:
        jfinal, tfinal = forge(jfinal, "jax"), forge(tfinal, "torch")
    res = []
    for mod, net, final in ((jobs, jnet, jfinal), (tobs, tnet, tfinal)):
        rec = mod.FlightRecorder()
        sent = mod.InvariantSentinel(net=net, capacity_table={} if table is None else table,
                                     recorder=rec)
        ctx = mod.TraceContext(run_id="sentinel-1")
        found = sent.check(final, ctx=ctx, chunk=3, **check_kw)
        again = sent.check(final, chunk=4, **check_kw)  # latched
        res.append((found, again, sent.violations, _events(rec), sent.protocol))
    assert res[1] == res[0]
    return res[1]


def test_healthy_runs_stay_silent(finals):
    for protocol in ("PingPong", "P2PFlood"):
        found, _, violations, events, name = _both_sentinels(finals, protocol)
        assert found == violations == events == [] and name == protocol
    members = [{"job_id": "a", "run_id": "ra", "tenant": "acme"},
               {"job_id": "b", "run_id": "rb", "tenant": "beta"}]
    assert _both_sentinels(finals, "P2PFlood", members=members, capacity=3)[0] == []


def _forge_drop(final, pkg):
    if pkg == "jax":
        d = np.array(np.asarray(final.dropped), copy=True)
        d.reshape(-1)[-1] = 7
        return final._replace(dropped=d)
    d = final.dropped.clone()
    d.view(-1)[-1] = 7
    return final._replace(dropped=d)


def test_capacity_dropped_alert_equals_jax(finals):
    table = {"pingpong@32": {"dropped": 0, "sized": {}}}
    found, again, violations, events, _ = _both_sentinels(finals, "PingPong", _forge_drop,
                                                          table)
    (v,) = [f for f in found if f["slo"] == "capacity-dropped"]
    assert v["dropped"] == 7 and v["replica"] == 1 and v["n_nodes"] == 32 and "mtype" in v
    assert again == [] or all(f["slo"] == "capacity-dropped" for f in again)
    assert [e["kind"] for e in events] == ["invariant-violation"]
    assert events[0]["run_id"] == "sentinel-1" and events[0]["protocol"] == "PingPong"


def test_hwm_headroom_alert_equals_jax(finals):
    hwm = int(finals["PingPong"][3].tele.wheel_fill_hwm.max())
    assert hwm > 0
    table = {"pingpong@32": {"dropped": 0, "sized": {"wheel_slots": hwm}}}
    found = _both_sentinels(finals, "PingPong", table=table)[0]
    (v,) = [f for f in found if f["slo"] == "hwm-headroom"]
    assert v["hwm"] == hwm and v["which"] == "wheel_fill_hwm"


def _forge_sent(final, pkg):
    tele = final.tele
    if pkg == "jax":
        s = np.array(np.asarray(tele.sent), copy=True)
        s.reshape(-1)[0] += 5
        return final._replace(tele=tele._replace(sent=s.astype(np.asarray(tele.sent).dtype)))
    s = tele.sent.clone()
    s.view(-1)[0] += 5
    return final._replace(tele=tele._replace(sent=s))


def test_store_invariant_alert_equals_jax(finals):
    found = _both_sentinels(finals, "PingPong", _forge_sent)[0]
    assert [f["slo"] for f in found] == ["store-invariant"]
    assert found[0]["sent"] == found[0]["delivered"] + found[0]["discarded"] + 5 + (
        found[0]["dropped"] + found[0]["pending"])


def test_attribution_reconcile_with_members_equals_jax(finals):
    members = [{"job_id": "a", "run_id": "ra", "tenant": "acme"},
               {"job_id": "b", "run_id": "rb", "tenant": "acme"},
               {"job_id": "c", "run_id": "rc", "tenant": "beta"}]
    assert _both_sentinels(finals, "P2PFlood", members=members, capacity=3)[0] == []


@pytest.mark.parametrize("garbage", [object(), None, {"done_at": 3}, ()],
                         ids=["object", "none", "dict", "tuple"])
def test_never_raises_on_garbage(garbage):
    res = []
    for mod in (jobs, tobs):
        rec = mod.FlightRecorder()
        sent = mod.InvariantSentinel(capacity_table={}, recorder=rec)
        assert sent.check(garbage) == []
        res.append((sent.violations, _events(rec)))
    assert res[1] == res[0]
    assert "sentinel error" in res[1][0][0]["detail"]


def test_sentinel_never_changes_the_state(finals):
    _, _, tnet, tfinal = finals["PingPong"]
    before = state_to_numpy(tfinal)
    sent = tobs.InvariantSentinel(net=tnet, recorder=tobs.FlightRecorder(),
                                  capacity_table={"pingpong@32": {"dropped": 0, "sized": {}}})
    sent.check(tfinal)
    same_tree(before, state_to_numpy(tfinal))


# -- neutrality and the manifest ------------------------------------------------


def _handel16(tele):
    from wittgenstein_tpu_torch.protocols.handel import HandelParameters
    from wittgenstein_tpu_torch.protocols.handel_batched import make_handel

    p = HandelParameters(node_count=16, threshold=12, pairing_time=3, level_wait_time=20,
                         extra_cycle=5, dissemination_period_ms=10, fast_path=10, nodes_down=0)
    return make_handel(p, telemetry=tele, device="cpu")


@pytest.mark.parametrize("protocol", ["PingPong", "P2PFlood", "Handel"])
def test_monitors_are_bitwise_neutral(protocol):
    net, state = (_handel16(TelemetryConfig(**TELE)) if protocol == "Handel"
                  else _build("torch", protocol))
    states = replicate_state(state, 2)

    def run(armed: bool):
        kw = {}
        if armed:
            store = tobs.TimeSeriesStore()
            kw = dict(timeseries=store, ctx=tobs.mint_context("mc"),
                      sentinel=tobs.InvariantSentinel(net=net, recorder=tobs.FlightRecorder()))
        rep = trt.Supervisor.from_network(net, states, total_ms=40, chunk_ms=20, **kw).run()
        assert rep.ok
        if armed:
            assert store.count("supervisor.chunk_seconds") == 2
            assert store.last("supervisor.wheel_fill_hwm") is not None
            assert kw["sentinel"].violations == []
        return state_to_numpy(rep.state)

    same_tree(run(False), run(True))


def test_timeseries_rides_the_checkpoint_manifest_across_packages(finals, tmp_path):
    """A partial run's history rides the manifest: a fresh store adopts it
    on resume, in the same package and across them."""
    for first, second in ((trt, trt), (jrt, trt), (trt, jrt)):
        ck = str(tmp_path / f"{first.__name__}-{second.__name__}".replace(".", "_"))
        reps = []
        for i, rt in enumerate((first, second)):
            pkg = "jax" if rt is jrt else "torch"
            net, state = _build(pkg, "PingPong")
            states = (jreplicate if rt is jrt else replicate_state)(state, 2)
            store = (jobs if rt is jrt else tobs).TimeSeriesStore()
            kw = {"max_chunks_this_run": 2} if i == 0 else {}
            reps.append(rt.Supervisor.from_network(
                net, states, total_ms=80, chunk_ms=20, checkpoint_dir=ck,
                timeseries=store, **kw).run())
            assert store.count("supervisor.chunk_seconds") == (2 if i == 0 else 4)
        assert not reps[0].ok and reps[1].ok
        assert reps[1].provenance["resumed_from_step"] == 2


# -- the capacity table and attribution ----------------------------------------


def test_capacity_copy_is_the_root_file():
    assert filecmp.cmp(os.path.join(ROOT, "CAPACITY.json"), tcap.capacity_path(), shallow=False)
    assert tcap.capacity_path(ROOT) == jcap.capacity_path(ROOT)
    assert tcap.load_capacity() == jcap.load_capacity() is not None
    assert tobs.load_capacity_table() == jobs.load_capacity_table()
    assert "handel@4096" in tobs.load_capacity_table()
    assert tobs.load_capacity_table(str(ROOT) + "/no-such-dir") == {}


def test_capacity_functions_equal_jax_over_every_entry():
    table = jcap.load_capacity()
    assert tcap.validate_table(table) == jcap.validate_table(table) == []
    for key, e in table["entries"].items():
        t = tcap.lookup(table, e["protocol"], e["n_nodes"])
        j = jcap.lookup(table, e["protocol"], e["n_nodes"])
        assert dataclasses.asdict(t) == dataclasses.asdict(j) and t.key == j.key == key
        assert t.to_json() == j.to_json()
        assert tcap.sized_overrides(t) == jcap.sized_overrides(j)
    assert tcap.lookup(table, "handel", 4095) is None and tcap.lookup(None, "handel", 1) is None
    assert tcap.sized_overrides(None) == jcap.sized_overrides(None)
    for hwm in (0, 1, 7, 8, 82, 100, 1023):
        for margin in (1.0, 1.5, 2.25):
            for floor in (8, 16):
                assert tcap.size_from_hwm(hwm, margin, floor) == jcap.size_from_hwm(hwm, margin,
                                                                                   floor)


def test_validate_table_problems_equal_jax():
    table = json.loads(json.dumps(jcap.load_capacity()))
    e = table["entries"]
    e["gsf@64"]["sized"]["overflow_capacity"] = 8
    e["handel@4096"]["sized"]["cand_slots"] = 4
    e["paxos@6"]["dropped"] = 3
    del e["slush@100"]["hwms"]
    e["enr@29"]["n_nodes"] = 30
    e["dfinity@31"]["hwms"].pop("wheel_fill_hwm")
    problems = tcap.validate_table(table)
    assert problems == jcap.validate_table(table) and len(problems) == 6
    for doc in ([], {"schema": "x"}, {"schema": tcap.CAPACITY_SCHEMA, "entries": 3}):
        assert tcap.validate_table(doc) == jcap.validate_table(doc)


def test_attribution_equals_jax(finals):
    jnet, jfinal, tnet, tfinal = finals["P2PFlood"]
    jr, tr = jobs.replica_rows(jnet, jfinal), tobs.replica_rows(tnet, tfinal)
    assert set(jr) == set(tr)
    for k in jr:
        if isinstance(jr[k], np.ndarray):
            assert np.array_equal(jr[k], tr[k]), k
        else:
            assert jr[k] == tr[k], k
    members = [{"job_id": "a", "run_id": "ra", "tenant": "acme"},
               {"job_id": "b", "run_id": "rb"}]
    for cap in (2, 3, 8):
        t = tobs.batch_attribution(tnet, tfinal, members, cap)
        assert t == jobs.batch_attribution(jnet, jfinal, members, cap)
    assert sum(v["device_time_share"] for v in t["tenants"].values()) == pytest.approx(1.0)
    # without telemetry the tick columns are None
    assert tobs.replica_rows(None, tfinal._replace(tele=()))["ticks"] is None
