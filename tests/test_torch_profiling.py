"""The port's profiling package and profiler reader against the JAX
package's.

The memory model, the budget arithmetic, the probe's run-record fields,
`format_bytes` and the lever report give the JAX package's results on
the same inputs: dicts of numpy leaves, Handel at 64 nodes (every leaf
named by the JAX package's path string, the same totals and bytes by
dtype), a fixed ablation matrix.  The ablation matrix runs on the CPU at
64 nodes and refuses the two levers the port has no switch for; a
recorded call summarises into the run cache's program record; the
profiler reader gives torch's own reading of a CPU window.
"""

import json

import numpy as np
import pytest
import torch

from wittgenstein_tpu.profiling import ablation as jabl
from wittgenstein_tpu.profiling import budget as jbudget
from wittgenstein_tpu.profiling import hbm as jhbm
from wittgenstein_tpu.profiling import probe as jprobe
from wittgenstein_tpu.profiling import xla_cost as jcost
from wittgenstein_tpu.protocols.handel_batched import make_handel as jmake_handel
from wittgenstein_tpu.telemetry import TelemetryConfig as JTele
from wittgenstein_tpu_torch.profiling import ablation as tabl
from wittgenstein_tpu_torch.profiling import budget as tbudget
from wittgenstein_tpu_torch.profiling import hbm as thbm
from wittgenstein_tpu_torch.profiling import probe as tprobe
from wittgenstein_tpu_torch.profiling import xla_cost as tcost
from wittgenstein_tpu_torch.protocols.handel_batched import make_handel as tmake_handel
from wittgenstein_tpu_torch.protocols.pingpong_batched import make_pingpong
from wittgenstein_tpu_torch.engine import replicate_state
from wittgenstein_tpu_torch.telemetry import TelemetryConfig as TTele
from wittgenstein_tpu_torch.telemetry.export import PromText
from wittgenstein_tpu_torch.tools import profiling as tprof

NUMPY_STATE = {
    "a": np.zeros((100,), np.int32),  # 400 B
    "b": np.zeros((10, 10), np.float32),  # 400 B
    "c": np.zeros((), np.bool_),  # 1 B
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_state_bytes_and_replicas_per_chip():
    rep = thbm.state_bytes_per_replica(NUMPY_STATE)
    assert rep == jhbm.state_bytes_per_replica(NUMPY_STATE)
    assert rep["total_bytes"] == 801 and rep["n_leaves"] == 3
    assert rep["top"][0][1] == 400  # largest leaves first
    model = thbm.replicas_per_chip(NUMPY_STATE, hbm_gib=1.0, overhead=2.0, reserved_gib=0.5)
    assert model == jhbm.replicas_per_chip(NUMPY_STATE, hbm_gib=1.0, overhead=2.0,
                                           reserved_gib=0.5)
    assert model["replicas"] == int(0.5 * 1024**3 // (801 * 2.0))
    as_tensors = {k: torch.from_numpy(v) for k, v in NUMPY_STATE.items()}
    assert thbm.state_bytes_per_replica(as_tensors) == rep


def test_hbm_report_cross_check():
    """The JAX test's measured cross-check, then Handel at 64 nodes with
    the telemetry side-car: the same leaves, paths, totals and bytes by
    dtype as the JAX package's."""
    memory = {"argument_size_in_bytes": 4000, "output_size_in_bytes": 4000,
              "temp_size_in_bytes": 100, "live_bytes": 8100}
    state = {"a": np.zeros((1000,), np.float32)}
    rep = thbm.hbm_report(state, memory=memory, hbm_gib=16.0)
    want = jhbm.hbm_report(state, memory=memory)
    assert {k: v for k, v in rep.items() if k != "measured"} == \
        {k: v for k, v in want.items() if k != "measured"}
    assert rep["measured"]["modeled_bytes"] == 8000 == want["measured"]["modeled_bytes"]
    for k in ("live_bytes_1_replica", "model_over_measured", "model_over_state_bytes",
              "temp_share_of_live"):
        assert rep["measured"][k] == want["measured"][k], k
    _, jstate = jmake_handel(tabl.flagship_params(64), telemetry=JTele(snapshots=8))
    _, tstate = tmake_handel(tabl.flagship_params(64), telemetry=TTele(snapshots=8),
                             device="cpu")
    t, j = thbm.state_bytes_per_replica(tstate), jhbm.state_bytes_per_replica(jstate)
    assert t == j
    assert thbm.hbm_report(tstate, hbm_gib=16.0) == jhbm.hbm_report(jstate, hbm_gib=16.0)


def test_required_tick_us_arithmetic():
    for args in ((1000, 1000, 21.0), (144, 549.0), (16, 549, 1.0)):
        assert tbudget.required_tick_us(*args) == jbudget.required_tick_us(*args)
    for bad in ((0, 1000), (10, -1), (10, 10, 0.0)):
        for lib in (tbudget, jbudget):
            with pytest.raises(ValueError):
                lib.required_tick_us(*bad)


def test_budget_from_parts_and_headroom():
    hbm = {"model": {"replicas": 144, "bytes_per_replica": 111 << 20}}
    kw = dict(ticks_per_sim=500.0, hbm=hbm, measured={"tick_us": 1000.0},
              config={"node_count": 4096})
    doc = tbudget.budget_from_parts(**kw)
    assert doc == jbudget.budget_from_parts(**kw)
    assert doc["headroom_factor"] == pytest.approx(144 / (21.0 * 500.0) * 1e6 / 1000.0,
                                                   abs=0.001)
    assert tbudget.budget_from_parts(549.0, hbm) == jbudget.budget_from_parts(549.0, hbm)


def test_load_budget_and_schema_gate(tmp_path):
    p = tmp_path / "BUDGET.json"
    assert tbudget.load_budget(path=str(p)) is None
    p.write_text(json.dumps({"schema": "other/v9"}))
    assert tbudget.load_budget(path=str(p)) is None
    p.write_text(json.dumps({"schema": "witt-budget/v1", "required_tick_us": 5}))
    assert tbudget.load_budget(path=str(p))["required_tick_us"] == 5
    (tmp_path / "data").mkdir()
    (tmp_path / "data" / "BUDGET.json").write_text(p.read_text())
    assert tbudget.load_budget(root=str(tmp_path))["required_tick_us"] == 5


def test_committed_budget_is_the_cards():
    """The port's own data/BUDGET.json: parsed by the default path, the
    derivation's arithmetic, and the card's name and power limit beside
    the figures."""
    doc = tbudget.load_budget()
    assert doc is not None
    assert doc["required_tick_us"] == pytest.approx(
        tbudget.required_tick_us(doc["replicas_per_chip"], doc["ticks_per_sim"]), rel=0.01)
    assert "H100" in doc["device"]["name"] and doc["device"]["power_limit"].endswith("W")
    assert doc["measured"]["device"] == doc["device"]
    assert tbudget.budget_staleness(doc, {"recorded": "2026-01-01"}) is None


def test_budget_staleness_dates_only():
    floor = {"recorded": "2026-08-05", "node_count": 256}
    for budget in ({"recorded": "2026-08-05"}, {"recorded": "2026-09-01"},
                   {"recorded": "2026-08-01"}, {}):
        t = tbudget.budget_staleness(budget, floor)
        assert (t is None) == (jbudget.budget_staleness(budget, floor) is None)
    assert "predates" in tbudget.budget_staleness({"recorded": "2026-08-01"}, floor)


def _verdict(platform="cpu", reason=None):
    return {
        "platform": platform,
        "fallback_reason": reason,
        "attempts": [{"platform": "tpu", "rc": 1}, {"platform": "cpu", "rc": 0}],
    }


def test_probe_verdict_fields():
    """The JAX package's fields for its verdicts (no cache: cache_age_s is
    None), and a device record's kind, count and power limit."""
    for reason in ("tpu probe failed (rc=1)", "cached probe verdict (cpu)"):
        v = _verdict(reason=reason)
        got, want = tprobe.probe_verdict_fields(v), jprobe.probe_verdict_fields(v)
        assert {k: got[k] for k in want if k != "cache_age_s"} == \
            {k: want[k] for k in want if k != "cache_age_s"}
        assert got["cache_age_s"] is None
    assert tprobe.probe_verdict_fields(_verdict())["from_cache"] is False
    rec = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
           "power_limit_w": 700.0}
    f = tprobe.probe_verdict_fields(rec)
    assert (f["platform"], f["kind"], f["count"], f["power_limit_w"], f["attempts"]) == \
        ("gpu", "NVIDIA H100 80GB HBM3", 1, 700.0, 0)
    p = PromText("witt")
    tprobe.add_probe_metrics(p, rec)
    text = p.render()
    assert 'witt_probe_platform_verdict{platform="gpu",kind="NVIDIA H100 80GB HBM3"} 1' in text
    assert "witt_probe_device_count 1" in text and "witt_probe_power_limit_watts 700.0" in text
    here = tprobe.device_record()
    assert here["platform"] == "cpu" and here["power_limit_w"] is None


def test_format_bytes():
    for n in (0, 512, 1023, 2048, 3 * 1024 * 1024, 111_149_056, 5 << 40, 7 << 50, -4096, "x"):
        assert tcost.format_bytes(n) == jcost.format_bytes(n)
    assert tcost.format_bytes(512) == "512 B" and tcost.format_bytes(2048) == "2.0 KiB"


MATRIX = {"configs": {
    "base": {"tick_us": 1000.0, "std_us": 5.0, "note": "b"},
    "channel_depth_8": {"tick_us": 900.0, "std_us": 4.0, "note": "d8"},
    "boundary_view_off": {"tick_us": 980.0, "std_us": 20.0, "note": "bv"},
    "pre_r5": {"tick_us": 870.0, "std_us": 3.0, "note": "r4"},
    "wheel": {"tick_us": 1200.0, "std_us": 6.0, "note": "w"},
    "wheel_fused": {"tick_us": 1190.0, "std_us": 6.0, "note": "wf"},
    "telemetry_on": {"tick_us": 1074.0, "std_us": 2.0, "note": "t"},
    "annotations_off": {"tick_us": 995.0, "std_us": 5.0, "note": "a"},
}}


def test_lever_report_matches_jax():
    assert tabl.lever_report(MATRIX) == jabl.lever_report(MATRIX)
    rep = tabl.lever_report(MATRIX)
    assert tabl.format_lever_report(rep) == jabl.format_lever_report(jabl.lever_report(MATRIX))
    assert [r["lever"] for r in rep["ranked_levers"]][:2] == ["wheel", "pre_r5"]
    assert tabl.LEVER_BASELINE == jabl.LEVER_BASELINE


def test_ablation_matrix_on_the_cpu():
    """Handel at 64 nodes x 2 on the CPU: base joins every matrix; the
    levers without a switch and unknown names raise before any build."""
    assert repr(tabl.flagship_params(256)) == repr(jabl.flagship_params(256))
    assert set(tabl.smoke_ablation_configs()) <= set(tabl._lever_builders(16, "cpu"))
    m = tabl.ablation_matrix(64, n_replicas=2, scans=1, repeats=2, warm_ms=5,
                             levers=["wheel", "faults_on"], device="cpu")
    assert m["backend"] == "cpu" and list(m["configs"]) == ["base", "wheel", "faults_on"]
    assert m["config"] == {"node_count": 64, "n_replicas": 2, "scans": 1, "repeats": 2,
                           "warm_ms": 5}
    assert all(c["tick_us"] > 0 and c["min_us"] <= c["tick_us"] for c in m["configs"].values())
    assert {r["lever"] for r in tabl.lever_report(m)["ranked_levers"]} == {"wheel", "faults_on"}
    for bad, match in ((["bitops_pallas"], "no switch"), (["annotations_off"], "annotations"),
                       (["base", "nope"], "unknown")):
        with pytest.raises(ValueError, match=match):
            tabl.ablation_matrix(64, levers=bad, device="cpu")


def test_recorded_call_summary():
    """A PingPong run on the CPU: wall seconds and hand-written launches
    (none on the CPU), a profiler window's launches and device ms, no
    allocator statistics."""
    net, state = make_pingpong(16, device="cpu")
    states = replicate_state(state, 2)
    out, rec = tcost.record_call(net.run_ms_batched, states, 20, device="cpu", profile=True)
    assert int(out.time[0]) == 20 and rec.wall_seconds > 0
    summary = tcost.compiled_cost_summary(rec, compile_seconds=0.0)
    assert summary == {"cost": {"wall_seconds": rec.wall_seconds, "hand_launches": 0,
                                "launches": 0, "device_ms": 0.0},
                       "memory": None, "compile_seconds": 0.0}
    assert tcost.memory_analysis_dict(rec) is None and tcost.cost_analysis_dict(None) is None


def test_window_reader_on_a_cpu_window(tmp_path):
    """A CPU window through trace(): the raw reading equals torch's own
    (no device events, every aten op's calls), the annotation lands in
    the trace file, and the wall clock times the block."""
    net, state = make_pingpong(16, device="cpu")
    states = replicate_state(state, 2)
    with tprof.WallClock() as clock:
        with tprof.trace(str(tmp_path)) as prof:
            with tprof.annotate("pingpong-window"):
                net.run_ms_batched(states, 10)
    w = tprof.window_events(prof)
    assert w == tprof.window_events(prof, through_torch=True)
    assert w.launches == 0 and w.device_ms == 0.0
    assert w.ops["aten::add"][0] > 0 and all(us == 0 for _, us in w.ops.values())
    assert "pingpong-window" in (tmp_path / "trace.json").read_text()
    assert clock.seconds > 0
