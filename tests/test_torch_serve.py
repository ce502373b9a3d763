"""The port's serving path (serve/) against the JAX package's.

The load-bearing contract, on the JAX package's own eight SCENARIOS
(PingPong, 32 nodes, 60 ms, seeds and fault plans as per-replica data):
each job's batched row, the port's run_singleton and the JAX package's
run_singleton give ONE state_digest, and one program serves the family.
A chunked Handel family at 64 nodes (flagship parameters, two horizons,
a crash plan) gives the JAX package's digests through its harvests.
Around it, on the port alone, each row still equal to its singleton:
admission control and Retry-After, cancellation, compatibility-key
splits (the pre-keys are the JAX package's strings), preemption and
resume, horizon sharding, harvest, salvage isolating an injected poison
row, lane failure and restart, binding expiry, drain and undrain.  The
key sets of health() and status() are the JAX package's, and the design
differences (the device argument, no compile store, lanes on the
scheduler's device) are pinned.
"""

import dataclasses
import time

import pytest
import torch

from test_serve import BASE, SCENARIOS
from wittgenstein_tpu.parallel.replica_shard import run_cache_info as jinfo
from wittgenstein_tpu.serve import BatchScheduler as JScheduler
from wittgenstein_tpu_torch.parallel.replica_shard import run_cache_info as tinfo
from wittgenstein_tpu_torch.protocols.handel import flagship_params
from wittgenstein_tpu_torch.runtime import LaneFailedError, SalvagePolicy
from wittgenstein_tpu_torch.serve import (
    BatchScheduler,
    DrainingError,
    JobQueue,
    JobState,
    QueueFullError,
)
from wittgenstein_tpu_torch.telemetry.export import PromText

HANDEL = {"protocol": "Handel", "params": dataclasses.asdict(flagship_params(64)),
          "chunkMs": 50}
HANDEL_SPECS = [
    {**HANDEL, "seed": 0, "simMs": 200},
    {**HANDEL, "seed": 1, "simMs": 150,
     "faults": [{"op": "crash", "nodes": list(range(6)), "at": 50, "recover": 100}]},
]
KEYS = ("hits", "misses", "compiles")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def jax_sched():
    return JScheduler(auto_start=False)


def _sched(**kw):
    kw.setdefault("auto_start", False)
    kw.setdefault("max_batch_replicas", 4)
    return BatchScheduler(device="cpu", **kw)


def _drain(sched):
    while sched.drain_once():
        pass


def _delta(before):
    return {k: tinfo()[k] - before[k] for k in KEYS}


def _same_as_singleton(sched, jobs, specs):
    for j, s in zip(jobs, specs):
        assert j.state is JobState.DONE, (s, j.error)
        assert j.result["time"] == s["simMs"]
        assert j.result["digest"] == sched.run_singleton(s)["digest"], s


def test_scenarios_one_digest_across_packages(jax_sched):
    """Batched row == the port's singleton == the JAX package's
    singleton, for each of the eight scenarios, from one program."""
    sched = _sched(max_batch_replicas=8)
    before = tinfo()
    jobs = [sched.submit(s) for s in SCENARIOS]
    assert len({j.compat for j in jobs}) == 1
    _drain(sched)
    assert _delta(before) == {"hits": 0, "misses": 1, "compiles": 1}
    _same_as_singleton(sched, jobs, SCENARIOS)
    for j, s in zip(jobs, SCENARIOS):
        assert j.result["digest"] == jax_sched.run_singleton(s)["digest"], s
    assert len({j.result["digest"] for j in jobs}) == len(SCENARIOS)
    assert jobs[0].progress and jobs[0].progress[-1]["time"] <= BASE["simMs"]
    assert sched.metrics.summary()["occupancy_avg"] == 1.0


def test_handel_chunked_family_equals_jax(jax_sched):
    """Two horizons in one chunked family: harvest compacts the batch to
    2 rows, then to 1 when the 150-ms job finishes; each width is one
    program, and every digest is the JAX package's."""
    sched = _sched(slice_chunks=2)
    before = tinfo()
    jobs = [sched.submit(s) for s in HANDEL_SPECS]
    assert jobs[0].compat == jobs[1].compat == jax_sched.pre_key(jobs[0].spec)
    _drain(sched)
    assert _delta(before) == {"hits": 2, "misses": 1, "compiles": 3}
    assert sched.metrics.harvests_total == 2
    for j, s in zip(jobs, HANDEL_SPECS):
        assert j.state is JobState.DONE, j.error
        assert j.result["digest"] == jax_sched.run_singleton(s)["digest"], s["seed"]
    assert jobs[1].result["digest"] == sched.run_singleton(HANDEL_SPECS[1])["digest"]


def test_health_and_status_keys_equal_jax(jax_sched):
    sched = _sched()
    health, jhealth = sched.health(), jax_sched.health()
    assert set(health) == set(jhealth)
    assert set(sched.status()) == set(jax_sched.status())
    assert health["compileStore"] == {"enabled": False, "counters": {}}
    assert set(health["runCache"]) == set(jinfo())
    assert set(health["lockTrace"]) == set(jhealth["lockTrace"])
    assert set(sched.slo_status()) == set(jax_sched.slo_status())
    assert health["lanesAlive"] == 0 and health["alerts"]["total"] == 0
    assert sched.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            BatchScheduler(auto_start=False)


def test_admission_and_retry_after():
    sched = _sched(queue=JobQueue(max_depth=2))
    for _ in range(2):
        sched.submit({**BASE, "seed": 0})
    with pytest.raises(QueueFullError) as e:
        sched.submit({**BASE, "seed": 0})
    assert e.value.retry_after_s >= 1 and sched.queue.rejected_total == 1
    for bad in ({"protocol": "NoSuchProtocol"},
                {"protocol": "PingPong", "simMs": 0},
                {"protocol": "PingPong", "simMs": 100, "chunkMs": 33},
                {"protocol": "PingPong", "faults": [{"op": "explode", "nodes": [1]}]}):
        with pytest.raises((ValueError, KeyError)):
            _sched().submit(bad)
    pacing = _sched()
    pacing._note_batch_time("fam-slow", 100.0)
    pacing._note_batch_time("fam-fast", 2.0)
    assert pacing.retry_after_s("fam-slow") > pacing.retry_after_s("fam-fast")
    assert pacing.retry_after_s("fam-unknown") >= 1


def test_cancellation():
    sched = _sched()
    keep = sched.submit({**BASE, "seed": 0})
    drop = sched.submit({**BASE, "seed": 1})
    assert sched.cancel(drop.id).state is JobState.CANCELLED
    assert drop.done_event.is_set() and sched.metrics.jobs_cancelled == 1
    _drain(sched)
    assert keep.state is JobState.DONE and drop.result is None


def test_compatibility_keys_equal_jax(jax_sched):
    sched = _sched()
    specs = [{**BASE, "seed": 0},
             {**BASE, "seed": 1, "faults": [{"op": "crash", "nodes": [1], "at": 10}]},
             {"protocol": "PingPong", "params": {"node_ct": 48}, "simMs": 60, "seed": 0},
             {**BASE, "seed": 0, "simMs": 100, "chunkMs": 50},
             HANDEL_SPECS[0]]
    jobs = [sched.submit(s) for s in specs]
    keys = [j.compat for j in jobs]
    assert keys[0] == keys[1] and len(set(keys)) == 4
    assert keys == [jax_sched.pre_key(j.spec) for j in jobs]
    plans = sched.plan_batches()
    assert [set(p["jobs"]) for p in plans] == [
        {jobs[0].id, jobs[1].id}, {jobs[2].id}, {jobs[3].id}, {jobs[4].id}]


def test_preemption_parks_and_resumes_bitwise():
    sched = _sched(slice_chunks=1)
    low_spec = {**BASE, "seed": 3, "simMs": 200, "chunkMs": 50}
    hi_spec = {**BASE, "seed": 9, "priority": 5}
    low = sched.submit(low_spec)
    assert sched.drain_once()  # slice 1: the batch parks, checkpointed
    assert low.state is JobState.RUNNING and low.progress
    hi = sched.submit(hi_spec)
    assert sched.drain_once()  # the high-priority batch jumps ahead
    assert hi.state is JobState.DONE and low.state is JobState.RUNNING
    _drain(sched)
    assert sched.metrics.preemptions_total == 1 and sched.metrics.resumes_total == 1
    _same_as_singleton(sched, [low, hi], [low_spec, {**hi_spec, "simMs": 60}])


def test_horizon_sharding_and_harvest():
    """Mixed horizons share one family (a 30-ms quantum remainder rides
    a 1-row program); with harvest on, the survivor is compacted to the
    1-row bucket, and every row equals its singleton."""
    specs = [{**BASE, "seed": 1, "simMs": 100}, {**BASE, "seed": 2, "simMs": 100},
             {**BASE, "seed": 3, "simMs": 100}, {**BASE, "seed": 4, "simMs": 230}]
    for harvest in (False, True):
        sched = _sched(horizon_quantum_ms=50, harvest=harvest)
        before = tinfo()
        jobs = [sched.submit(s) for s in specs]
        assert len({j.compat for j in jobs}) == 1
        if harvest:
            assert sched.drain_once()
            (parked,) = sched._parked
            assert parked.capacity == 1 and parked.batch_id.endswith("-h1")
            assert parked.job_chunks == [2] and parked.job_rems == [30]
        _drain(sched)
        _same_as_singleton(sched, jobs, specs)
        m = sched.metrics.summary()
        assert m["harvests_total"] == int(harvest)
        assert m["harvest_rows_freed_total"] == 3 * int(harvest)
        assert _delta(before)["compiles"] == 2 + int(harvest)
    p = PromText()
    sched.metrics.add_prometheus(p, sched.queue)
    text = p.render()
    assert "witt_serve_harvests_total 1" in text
    assert "witt_serve_compile_cache_hit_ratio" in text


def _poison(job_id):
    def injector(fam, jobs):
        if any(j.id == job_id for j in jobs):
            raise RuntimeError(f"chaos: poison row {job_id}")
    return injector


@pytest.mark.parametrize("chunked", [False, True], ids=["direct", "chunked"])
def test_salvage_quarantines_the_poison_row(chunked):
    if chunked:
        sched = _sched(horizon_quantum_ms=20)
        specs = [{**BASE, "seed": 0, "simMs": 40}, {**BASE, "seed": 1, "simMs": 60},
                 {**BASE, "seed": 2, "simMs": 50}]
    else:
        sched = _sched()
        specs = [{**BASE, "seed": i} for i in range(4)]
    jobs = [sched.submit(s) for s in specs]
    bad = jobs[1]
    sched.chaos_injector = _poison(bad.id)
    _drain(sched)
    assert bad.state is JobState.QUARANTINED and bad.error_kind == "poison_row"
    assert bad.to_dict()["errorKind"] == "poison_row"
    rest = [(j, s) for j, s in zip(jobs, specs) if j is not bad]
    _same_as_singleton(sched, *zip(*rest))
    assert sched.metrics.jobs_quarantined == 1 and sched.metrics.salvage_batches_total == 1


def test_salvage_off_or_out_of_budget_fails_honestly():
    for policy in (SalvagePolicy(enabled=False), SalvagePolicy(max_probe_runs=0)):
        sched = _sched(salvage=policy)
        jobs = [sched.submit({**BASE, "seed": i}) for i in range(3)]
        sched.chaos_injector = _poison(jobs[0].id)
        _drain(sched)
        assert all(j.state is JobState.FAILED for j in jobs)


def test_lane_failure_restart_and_binding_expiry():
    sched = BatchScheduler(device="cpu", max_batch_replicas=4, binding_ttl_s=0.0)
    warm = sched.submit({**BASE, "seed": 5})
    assert warm.done_event.wait(120)
    sched.inject_lane_failure(0)
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline and sched.metrics.lane_restarts_total < 1:
        time.sleep(0.02)
    assert sched.metrics.lane_failures_total == sched.metrics.lane_restarts_total == 1
    after_spec = {**BASE, "seed": 6}
    after = sched.submit(after_spec)
    assert after.done_event.wait(120)
    sched.stop()
    _same_as_singleton(sched, [after], [after_spec])
    assert sched.health()["errorKinds"].get("lane_failed", 0) >= 1
    sched._reap_bindings()  # ttl 0: an idle binding goes at once
    assert after.compat not in sched._family_lane
    lanes = _sched()
    a = lanes.submit({**BASE, "seed": 0})
    assert lanes.drain_once() and lanes._family_lane[a.compat] == 0
    lanes._on_lane_failure(lanes._lanes[0], LaneFailedError(0, "test"))
    assert a.compat not in lanes._family_lane  # one lane: the binding drops
    assert lanes.metrics.lane_rebinds_total == 1
    lanes.stop()


def test_drain_and_undrain_resume_bitwise():
    sched = _sched(slice_chunks=1)
    spec = {**BASE, "seed": 3, "simMs": 200, "chunkMs": 50}
    job = sched.submit(spec)
    assert sched.drain_once()
    sched.drain()
    with pytest.raises(DrainingError) as e:
        sched.submit({**BASE, "seed": 0})
    assert e.value.retry_after_s >= 1
    assert not sched.drain_once() and job.state is JobState.RUNNING
    assert sched.quiescent() and len(sched._parked) == 1
    sched.undrain()
    _drain(sched)
    _same_as_singleton(sched, [job], [spec])
    assert sched.metrics.drains_total == 1


def test_lanes_stay_on_the_schedulers_device():
    with pytest.raises(ValueError, match="exceeds visible devices"):
        _sched(device_groups=2)
    with pytest.raises(ValueError, match="node_parallel=2 must divide"):
        _sched(node_parallel=2)
    with pytest.raises(ValueError, match="device_groups must be >= 1"):
        _sched(device_groups=0)
