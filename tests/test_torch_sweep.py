"""The port's sweep runner against the JAX package's.

`run_sweep` gives the JAX package's BasicStats for the tor battery's 0.0
and 0.5 points and the cities corner of logStartTime (the Byzantine
list: tests/test_torch_sweep_byzantine.py), and `default_params` its
parameters; under a TelemetryConfig its telemetry records
(the getters' reductions, the counters, the progress series and the
host-side CDF) are the JAX package's too.  `run_fault_sweep` with a
duplicated plan gives the JAX package's records, dedupe counters and
out-state leaves; its resumable and cached paths raise.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_paxos import assert_same_state, jax_numpy
from wittgenstein_tpu.faults import FaultPlan as JPlan
from wittgenstein_tpu.protocols.pingpong_batched import make_pingpong as jmake_pp
from wittgenstein_tpu.scenarios import handel_scenarios as jsc
from wittgenstein_tpu.scenarios import sweep as jsweep
from wittgenstein_tpu.telemetry import TelemetryConfig as JTele
from wittgenstein_tpu_torch.faults import FaultPlan as TPlan
from wittgenstein_tpu_torch.interop import state_to_numpy
from wittgenstein_tpu_torch.protocols.pingpong_batched import make_pingpong as tmake_pp
from wittgenstein_tpu_torch.scenarios import handel_scenarios as tsc
from wittgenstein_tpu_torch.scenarios import sweep as tsweep
from wittgenstein_tpu_torch.telemetry import TelemetryConfig as TTele

CASES = {
    # (configs from a scenarios module, replicas, sim_ms, stop_when_done);
    # the Byzantine list: tests/test_torch_sweep_byzantine.py
    "tor": (lambda m: [m.tor_configs(32)[i] for i in (0, 5)], 2, 700, False),
    "cities_start_time": (lambda m: m.log_start_time_configs(64)[2:3], 2, 700, True),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("case", list(CASES))
def test_basic_stats_match(case):
    configs, replicas, ms, stop = CASES[case]
    want = jsweep.run_sweep(configs(jsc), replicas=replicas, sim_ms=ms, seed0=3,
                            stop_when_done=stop)
    got = tsweep.run_sweep(configs(tsc), replicas=replicas, sim_ms=ms, seed0=3,
                           stop_when_done=stop, device="cpu")
    assert [g.row() for g in got] == [w.row() for w in want]
    assert [str(g) for g in got] == [str(w) for w in want]
    assert any(g.done_at_max > 0 for g in got)


@pytest.mark.parametrize("kw", [
    {}, dict(dead_ratio=0.2, tor=0.2, loc="CITIES", desynchronized_start=100, level_wait_time=25),
    dict(dead_ratio=0.0, tor=0.5), dict(loc="AWS", period_time=40, extra_cycle=15, fast_path=5),
    dict(loc="RANDOM", window_initial=64, hidden_byzantine=True, dead_ratio=0.9),
    dict(byzantine_suicide=True, dead_ratio=0.25),
], ids=["defaults", "cities", "tor", "aws", "random", "byzantine"])
def test_default_params_match(kw):
    assert dataclasses.asdict(tsweep.default_params(256, **kw)) == \
        dataclasses.asdict(jsweep.default_params(256, **kw))


def test_telemetry_records_match():
    """Two desynchronized-start configs (one group) under telemetry: every
    record field equal, the ring's progress and the host CDF included."""
    want, got = [], []
    ws = jsweep.run_sweep(jsc.desync_configs(16)[1:3], replicas=2, sim_ms=400,
                          telemetry=JTele(snapshots=32, snapshot_every_ms=20),
                          telemetry_out=want)
    gs = tsweep.run_sweep(tsc.desync_configs(16)[1:3], replicas=2, sim_ms=400,
                          telemetry=TTele(snapshots=32, snapshot_every_ms=20),
                          telemetry_out=got, device="cpu")
    assert [g.row() for g in gs] == [w.row() for w in ws]
    assert len(got) == 2 and got == want
    assert got[0]["progress"][0] and got[0]["doneAtCdfHost"]["times"][0] == 19


def _plans(lib):
    crash = lib("crash").crash(range(2, 6), at=40, recover=160)
    return [crash, None, lib("drop").drop(200, start=20), lib("crash").crash(
        range(2, 6), at=40, recover=160)]


def test_fault_sweep_matches():
    """A duplicated crash plan runs once (its record fans back out to both
    positions); the records, the counters' deltas and the out state equal
    the JAX package's."""
    jnet, jstate = jmake_pp(16)
    tnet, tstate = tmake_pp(16, device="cpu")
    j0, t0 = jsweep.sweep_counters(), tsweep.sweep_counters()
    jout, jrec = jsweep.run_fault_sweep(jnet, jstate, _plans(JPlan), 300, replicas_per_plan=2,
                                        seed0=5, done_cdf_every=50)
    tout, trec = tsweep.run_fault_sweep(tnet, tstate, _plans(TPlan), 300, replicas_per_plan=2,
                                        seed0=5, done_cdf_every=50)
    assert trec == jrec
    assert trec[0]["plan_digest"] == trec[3]["plan_digest"] != trec[1]["plan_digest"]
    delta = {k: tsweep.sweep_counters()[k] - t0[k] for k in t0}
    assert delta == {k: jsweep.sweep_counters()[k] - j0[k] for k in j0}
    assert delta == {"plans_in": 4, "plans_evaluated": 3, "plans_deduped": 1}
    assert tout.done_at.shape[0] == 6
    assert_same_state(jax_numpy(jout), state_to_numpy(tout), "fault sweep")
    assert np.asarray(jout.faults.dropped_by_fault).sum() > 0


@pytest.mark.parametrize("kw", [dict(checkpoint_dir="x"), dict(chunk_ms=100),
                                dict(supervisor_kw={}), dict(use_run_cache=True)],
                         ids=["checkpoint_dir", "chunk_ms", "supervisor_kw", "use_run_cache"])
def test_unported_fault_sweep_paths_raise(kw, tmp_path):
    """use_run_cache (parallel.replica_shard, Queue A 16) is the one path
    left unported, and raises.  The resumable path's arguments are ported
    (test_torch_resumable_sweep.py): checkpoint_dir runs the sweep in one
    100-ms chunk under the supervisor; alone, chunk_ms and supervisor_kw
    are unused, as in the JAX package.  Each gives the plain sweep's
    state and records."""
    net, state = tmake_pp(16, device="cpu")
    if "use_run_cache" in kw:
        with pytest.raises(NotImplementedError, match="Queue A 16"):
            tsweep.run_fault_sweep(net, state, [None], 100, **kw)
        return
    if "checkpoint_dir" in kw:
        kw = {"checkpoint_dir": str(tmp_path / "ck")}
    out, records = tsweep.run_fault_sweep(net, state, [None], 100, **kw)
    plain, plain_records = tsweep.run_fault_sweep(net, state, [None], 100)
    assert records == plain_records
    assert_same_state(state_to_numpy(plain), state_to_numpy(out), str(kw))


def test_fault_sweep_argument_checks():
    net, state = tmake_pp(16, device="cpu")
    with pytest.raises(ValueError, match="at least one plan"):
        tsweep.run_fault_sweep(net, state, [], 100)
    with pytest.raises(ValueError, match="replicas_per_plan"):
        tsweep.run_fault_sweep(net, state, [None], 100, replicas_per_plan=0)
