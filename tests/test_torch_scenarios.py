"""The port's Handel scenario batteries against the JAX package's.

Every battery builds the JAX package's configurations (labels, values,
parameters) and `ALL_BATTERY` keeps the reference's CSV ids (the
inverted "301"/"30").  `run_scenario` writes the JAX package's CSV and
stdout lines, and with a graphs directory the reference's PNG pair;
`run_all` does the same over a one-sweep battery; `delayed_start_impact`
prints and returns the same numbers; `main` runs with `--device cpu`.
"""

import dataclasses

import pytest
import torch

from wittgenstein_tpu.scenarios import handel_scenarios as jsc
from wittgenstein_tpu_torch.scenarios import handel_scenarios as tsc
from wittgenstein_tpu_torch.scenarios.sweep import BasicStats


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _configs(m, name, n):
    kw = {"dead": 0.2, "tor": 0.2} if name in m._DEAD_TOR else {}
    return [(c.label, c.value, dataclasses.asdict(c.params)) for c in m.SCENARIOS[name](n, **kw)]


@pytest.mark.parametrize("name", sorted(jsc.SCENARIOS))
def test_battery_configs_match(name):
    assert sorted(tsc.SCENARIOS) == sorted(jsc.SCENARIOS)
    assert _configs(tsc, name, 256) == _configs(jsc, name, 256)


def test_all_battery_and_fields_match():
    assert tsc.CSV_FIELDS == jsc.CSV_FIELDS
    assert [(f.__name__, d, t, sid) for f, d, t, sid in tsc.ALL_BATTERY] == \
        [(f.__name__, d, t, sid) for f, d, t, sid in jsc.ALL_BATTERY]
    assert [sid for *_, sid in tsc.ALL_BATTERY][:2] == ["301", "30"]
    for (tf, d, t, sid), (jf, *_) in zip(tsc.ALL_BATTERY, jsc.ALL_BATTERY):
        assert [dataclasses.asdict(c.params) for c in tf(128, dead=d, tor=t, sid=sid)] == \
            [dataclasses.asdict(c.params) for c in jf(128, dead=d, tor=t, sid=sid)]


def test_run_scenario_matches(tmp_path, capsys):
    """logDelayedStart (one group: only the start delay moves) at 32 nodes:
    the same stats, stdout and CSV, and both PNGs under their reference
    names."""
    outs = []
    for m, dev in ((jsc, {}), (tsc, {"device": "cpu"})):
        d = tmp_path / m.__name__.split(".")[0]
        d.mkdir()
        stats = m.run_scenario("logDelayedStart", nodes=32, replicas=2, sim_ms=700,
                               out=str(d / "b.csv"), graphs_dir=str(d), **dev)
        outs.append(([s.row() for s in stats], capsys.readouterr().out.replace(str(d), "D"),
                     (d / "b.csv").read_text(), sorted(p.name for p in d.glob("*.png"))))
    assert outs[0] == outs[1]
    assert outs[1][3] == ["handel_delayedStart_msg.png", "handel_delayedStart_time.png"]
    assert any(row["done_at_max"] > 0 for row in outs[1][0])


def test_run_all_one_sweep_battery(tmp_path, capsys):
    def battery(m):
        def first(nodes, dead, tor, sid):
            return m.log_start_time_configs(nodes, dead=dead, tor=tor, sid=sid)[2:3]
        return [(first, 0.2, 0.0, "101")]

    texts = []
    for m, dev in ((jsc, {}), (tsc, {"device": "cpu"})):
        out = tmp_path / f"{m.__name__.split('.')[0]}.csv"
        m.run_all(32, 2, 600, str(out), battery=battery(m), **dev)
        texts.append((capsys.readouterr().out.replace(str(out), "OUT"), out.read_text()))
    assert texts[0] == texts[1]
    assert texts[1][1].startswith("allScenarios\nid,nodes,value,")
    assert "101, 32, 50," in texts[1][0]


def test_save_battery_graphs(tmp_path):
    configs = tsc.log_configs(256)
    stats = [BasicStats(1, 10 * i, 30, 2, 20 * i, 40, 3, 4) for i in range(len(configs))]
    paths = tsc.save_battery_graphs("log", configs, stats, str(tmp_path))
    assert [p.split("/")[-1] for p in paths] == ["handel_log_time.png", "handel_log_msg.png"]
    for p in paths:
        assert open(p, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
    assert tsc.save_battery_graphs("tor", configs, stats, str(tmp_path)) == []


@pytest.mark.parametrize("args", [(4096, 50, 20), (128, 0, 10), (1000, 30, 7)])
def test_delayed_start_impact_matches(args, capsys):
    want = jsc.delayed_start_impact(*args)
    want_out = capsys.readouterr().out
    assert tsc.delayed_start_impact(*args) == want
    assert capsys.readouterr().out == want_out


def test_main_runs_on_the_cpu(tmp_path, capsys):
    jsc.main(["delayedStart", "--nodes", "256", "--wait-time", "25", "--period", "10"])
    want = capsys.readouterr().out
    tsc.main(["delayedStart", "--nodes", "256", "--wait-time", "25", "--period", "10",
              "--device", "cpu"])
    assert capsys.readouterr().out == want
    texts = []
    for m, extra in ((jsc, []), (tsc, ["--device", "cpu"])):
        out = tmp_path / f"{m.__name__.split('.')[0]}.csv"
        m.main(["desync", "--nodes", "16", "--replicas", "2", "--sim-ms", "400",
                "--out", str(out)] + extra)
        capsys.readouterr()
        texts.append(out.read_text())
    assert texts[0] == texts[1] and texts[1].count("\n") == 8
