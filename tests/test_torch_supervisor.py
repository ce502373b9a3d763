"""The port's Supervisor against the JAX package's.

The JAX package's supervisor tests (its TestSupervisorLoop,
TestCheckpointResume, TestStableRunKey, TestKillAndResumeBitIdentity,
TestSupervisorValidation, TestErrorTaxonomyExtensions and
TestSupervisorShouldStop), each scenario run through both packages: the
same toy chunks, failures, budgets and checkpoints give the same final
state and the same provenance.  On real simulations the supervised
chunked pass — interrupted and resumed, with the fault and telemetry
side-cars — equals the JAX package's leaf for leaf.  Also:
`stable_run_key` renders the JAX package's string on PingPong, on Handel
with both side-cars and on ETHPoW without reading a leaf; a run started
under `torch.inference_mode()` runs its chunks on the watchdog thread
under it; a degraded run stamps its provenance and needs a CPU chunk
function when its state is not on the CPU.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wittgenstein_tpu import runtime as jrt
from wittgenstein_tpu.engine import replicate_state as jreplicate
from wittgenstein_tpu_torch import runtime as trt
from wittgenstein_tpu_torch.engine import replicate_state
from wittgenstein_tpu_torch.interop import state_to_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# -- helpers ---------------------------------------------------------------


def jtree(state) -> dict:
    """A JAX package SimState as the nested numpy dict state_to_numpy gives."""
    out = {}
    for f, v in state._asdict().items():
        if f == "proto":
            out[f] = {k: np.asarray(a) for k, a in v.items()}
        elif hasattr(v, "_asdict"):
            out[f] = {k: np.asarray(a) for k, a in v._asdict().items()}
        elif isinstance(v, tuple):
            out[f] = v
        else:
            out[f] = np.asarray(v)
    return out


def same_tree(a, b, tag=""):
    """Two nested numpy dicts equal leaf for leaf: names, dtypes, shapes, bits."""
    assert set(a) == set(b), tag
    for k, v in a.items():
        if isinstance(v, dict):
            same_tree(v, b[k], f"{tag}{k}.")
        elif isinstance(v, np.ndarray):
            w = np.asarray(b[k])
            assert v.dtype == w.dtype and v.shape == w.shape, tag + k
            assert np.array_equal(v, w), f"{tag}{k} differs"
        else:
            assert v == b[k], tag + k


def j_toy():
    return {"x": jnp.arange(4, dtype=jnp.int32), "step": jnp.int32(0)}


def t_toy():
    return {"x": torch.arange(4, dtype=torch.int32), "step": torch.tensor(0, dtype=torch.int32)}


def toy_chunk(s):
    return {"x": s["x"] * 2 + 1, "step": s["step"] + 1}


def t_after(n):
    s = t_toy()
    for _ in range(n):
        s = toy_chunk(s)
    return s


def toy_np(s) -> dict:
    return {k: np.asarray(v) if not isinstance(v, torch.Tensor) else v.numpy()
            for k, v in s.items()}


# provenance keys both packages fill the same way (times, ids and the
# platform name are the run's own)
PROV = ("degraded", "degraded_at_chunk", "resumed_from_step", "retries", "watchdog_timeouts",
        "checkpoints", "run_key", "chunk_ms", "n_chunks", "chunks_done")


def prov(rep) -> dict:
    out = {k: rep.provenance[k] for k in PROV}
    out["hist_count"] = rep.provenance["chunk_time_hist"]["count"]
    return out


def both(make_kw, tmp_path=None, runs=1):
    """Run one toy scenario through each package: `make_kw(pkg, tmp)`
    gives (chunk_fn, Supervisor kwargs); `runs` supervisors in a row on
    one checkpoint directory.  Returns each package's reports."""
    out = {}
    for pkg, rt, toy in (("jax", jrt, j_toy), ("torch", trt, t_toy)):
        tmp = None if tmp_path is None else str(tmp_path / pkg)
        reps = []
        for r in range(runs):
            fn, kw = make_kw(pkg, tmp, r)
            reps.append(rt.Supervisor(fn, toy(), **kw).run())
        out[pkg] = reps
    for j, t in zip(out["jax"], out["torch"]):
        assert t.ok == j.ok
        assert prov(t) == prov(j)
        same_tree(toy_np(j.state), toy_np(t.state))
    return out["torch"]


def _watchdog_threads(before=()) -> list:
    """The supervisor's watchdog threads alive now, less those in `before`
    (another test's abandoned worker may still be on its way out)."""
    return [t for t in threading.enumerate() if t.name == "witt-watchdog" and t not in before]


def _gone(before, timeout_s: float = 5.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while _watchdog_threads(before) and time.monotonic() < deadline:
        time.sleep(0.01)
    return not _watchdog_threads(before)


# -- the loop ----------------------------------------------------------------


class TestSupervisorLoop:
    def test_runs_all_chunks(self):
        (rep,) = both(lambda pkg, tmp, r: (toy_chunk, {"n_chunks": 5}))
        assert rep.ok and rep.chunks_done == 5 and len(rep.chunk_seconds) == 5
        assert rep.provenance["platform"] == "cpu"
        same_tree(toy_np(rep.state), toy_np(t_after(5)))

    def test_transient_retry_replays_from_anchor(self):
        def make(pkg, tmp, r):
            calls = {"n": 0}

            def flaky(s):
                calls["n"] += 1
                if calls["n"] == 3:
                    raise RuntimeError("UNAVAILABLE: tunnel reset")
                return toy_chunk(s)

            rt = jrt if pkg == "jax" else trt
            return flaky, dict(n_chunks=4, sleep=lambda s: None,
                               retry=rt.RetryPolicy(max_attempts=3, backoff_base_s=0.0))

        (rep,) = both(make)
        assert rep.ok and rep.provenance["retries"] == 1
        same_tree(toy_np(rep.state), toy_np(t_after(4)))

    def test_retries_exhausted_is_typed(self):
        def dead(s):
            raise RuntimeError("UNAVAILABLE: still down")

        for rt, toy in ((jrt, j_toy), (trt, t_toy)):
            with pytest.raises(rt.RetriesExhaustedError) as ei:
                rt.Supervisor(dead, toy(), n_chunks=2, sleep=lambda s: None,
                              retry=rt.RetryPolicy(max_attempts=3, backoff_base_s=0.0)).run()
            assert ei.value.attempts == 3 and "UNAVAILABLE" in str(ei.value.last)

    def test_fatal_error_raises_raw(self):
        def broken(s):
            raise ValueError("semantic bug")

        for rt, toy in ((jrt, j_toy), (trt, t_toy)):
            with pytest.raises(ValueError, match="semantic bug"):
                rt.Supervisor(broken, toy(), n_chunks=2).run()

    def test_watchdog_timeout_raises_in_loop(self):
        ev = threading.Event()

        def hang(s):
            ev.wait(30)
            return s

        with pytest.raises(trt.WatchdogTimeoutError) as ei:
            trt.Supervisor(hang, t_toy(), n_chunks=2,
                           watchdog=trt.WatchdogPolicy(chunk_deadline_s=0.05,
                                                       compile_deadline_s=0.05)).run()
        ev.set()
        assert ei.value.phase == "compile+chunk"  # the process's first call

    def test_watchdog_times_the_work_inside_the_sync(self, monkeypatch):
        """The sync runs on the worker, inside the deadline: a sync that
        hangs (a card that never finishes) is a watchdog miss."""
        from wittgenstein_tpu_torch.runtime import supervisor as sup_mod

        ev = threading.Event()
        monkeypatch.setattr(sup_mod, "_sync", lambda state: ev.wait(30))
        with pytest.raises(trt.WatchdogTimeoutError):
            trt.Supervisor(toy_chunk, t_toy(), n_chunks=2,
                           watchdog=trt.WatchdogPolicy(chunk_deadline_s=0.05,
                                                       compile_deadline_s=0.05)).run()
        ev.set()

    def test_heartbeat_sees_every_chunk(self):
        beats = {"jax": [], "torch": []}
        both(lambda pkg, tmp, r: (toy_chunk, dict(
            n_chunks=3, heartbeat=lambda i, dt: beats[pkg].append(i))))
        assert beats["torch"] == beats["jax"] == [0, 1, 2]

    def test_thread_count_stable_across_10_chunk_supervised_run(self):
        during, before = [], _watchdog_threads()
        rep = trt.Supervisor(
            toy_chunk, t_toy(), n_chunks=10,
            watchdog=trt.WatchdogPolicy(chunk_deadline_s=30.0, compile_deadline_s=30.0),
            heartbeat=lambda i, dt: during.append(len(_watchdog_threads(before))),
        ).run()
        assert rep.ok and rep.chunks_done == 10
        assert during == [1] * 10
        assert _gone(before)


class TestDegrade:
    def test_degrade_stamps_provenance(self):
        def make(pkg, tmp, r):
            calls = {"n": 0}
            rt = jrt if pkg == "jax" else trt

            def lossy(s):
                calls["n"] += 1
                if calls["n"] == 1:
                    raise rt.DeviceLostError("tpu is dead")
                return toy_chunk(s)

            return lossy, dict(n_chunks=3, sleep=lambda s: None,
                               retry=rt.RetryPolicy(max_attempts=3, backoff_base_s=0.0),
                               degrade=rt.DegradePolicy(cpu_fallback=True))

        (rep,) = both(make)
        assert rep.provenance["degraded"] is True
        assert rep.provenance["degraded_at_chunk"] == 0
        assert rep.provenance["platform"] == "cpu"
        same_tree(toy_np(rep.state), toy_np(t_after(3)))

    def test_degraded_run_continues_on_its_cpu_chunk_fn(self):
        used = []

        def card(s):
            raise trt.DeviceLostError("CUDA error: an illegal memory access was encountered")

        def cpu(s):
            used.append(s["x"].device.type)
            return toy_chunk(s)

        rep = trt.Supervisor(card, t_toy(), n_chunks=3, cpu_chunk_fn=cpu, sleep=lambda s: None,
                             retry=trt.RetryPolicy(max_attempts=3, backoff_base_s=0.0),
                             degrade=trt.DegradePolicy(cpu_fallback=True)).run()
        assert rep.ok and used == ["cpu"] * 3
        assert (rep.provenance["degraded"], rep.provenance["degraded_at_chunk"],
                rep.provenance["platform"]) == (True, 0, "cpu")
        same_tree(toy_np(rep.state), toy_np(t_after(3)))

    def test_degrade_off_card_without_cpu_chunk_fn_raises(self):
        """A state off the CPU cannot continue on the CPU through the
        card's chunk function: without a cpu_chunk_fn the run raises
        instead of degrading."""
        from wittgenstein_tpu_torch.runtime import supervisor as sup_mod

        class OnCard(trt.Supervisor):
            """A supervisor whose run's device is the card; its states
            stay on the CPU here, where there is none."""

            def _place(self, host_state):
                return sup_mod._from_host(host_state, torch.device("cpu"))

        def lossy(s):
            raise trt.DeviceLostError("gone")

        sup = OnCard(lossy, t_toy(), n_chunks=2, sleep=lambda s: None,
                     retry=trt.RetryPolicy(max_attempts=3, backoff_base_s=0.0),
                     degrade=trt.DegradePolicy(cpu_fallback=True))
        sup.device = torch.device("cuda")
        with pytest.raises(trt.FatalRunError, match="cpu_chunk_fn"):
            sup.run()
        assert trt.DegradePolicy().cpu_fallback is False

    def test_device_lost_without_degrade_retries_in_place(self):
        calls = {"n": 0}

        def lossy(s):
            calls["n"] += 1
            if calls["n"] == 2:
                raise RuntimeError("CUDA error: unspecified launch failure")
            return toy_chunk(s)

        rep = trt.Supervisor(lossy, t_toy(), n_chunks=3, sleep=lambda s: None,
                             retry=trt.RetryPolicy(max_attempts=3, backoff_base_s=0.0)).run()
        assert rep.ok and rep.provenance["degraded"] is False
        assert rep.provenance["retries"] == 1
        same_tree(toy_np(rep.state), toy_np(t_after(3)))


# -- checkpoints -------------------------------------------------------------


class TestCheckpointResume:
    def test_partial_stop_then_resume_is_bitwise(self, tmp_path):
        def make(pkg, tmp, r):
            kw = dict(n_chunks=5, checkpoint_dir=tmp, run_key="toy:5")
            if r == 0:
                kw["max_chunks_this_run"] = 2
            return toy_chunk, kw

        rep1, rep2 = both(make, tmp_path, runs=2)
        assert not rep1.ok and rep1.chunks_done == 2
        assert rep2.ok and rep2.chunks_done == 5
        assert rep2.provenance["resumed_from_step"] == 2
        same_tree(toy_np(rep2.state), toy_np(t_after(5)))

    def test_off_cadence_partial_stop_still_checkpoints(self, tmp_path):
        def make(pkg, tmp, r):
            kw = dict(n_chunks=6, checkpoint_dir=tmp, checkpoint_every=4)
            if r == 0:
                kw["max_chunks_this_run"] = 3
            return toy_chunk, kw

        rep1, rep2 = both(make, tmp_path, runs=2)
        assert not rep1.ok and rep1.chunks_done == 3
        assert rep2.ok and rep2.provenance["resumed_from_step"] == 3

    def test_run_key_mismatch_refuses_resume(self, tmp_path):
        ck = str(tmp_path / "ck")
        trt.Supervisor(toy_chunk, t_toy(), n_chunks=4, checkpoint_dir=ck, run_key="run-A",
                       max_chunks_this_run=1).run()
        with pytest.raises(trt.ResumeMismatchError, match="run-A"):
            trt.Supervisor(toy_chunk, t_toy(), n_chunks=4, checkpoint_dir=ck,
                           run_key="run-B").run()

    def test_chunk_geometry_mismatch_refuses_resume(self, tmp_path):
        ck = str(tmp_path / "ck")
        trt.Supervisor(toy_chunk, t_toy(), n_chunks=4, chunk_ms=50, checkpoint_dir=ck,
                       max_chunks_this_run=1).run()
        with pytest.raises(trt.ResumeMismatchError, match="chunk_ms"):
            trt.Supervisor(toy_chunk, t_toy(), n_chunks=4, chunk_ms=100,
                           checkpoint_dir=ck).run()

    def test_meta_carries_cumulative_chunk_seconds(self, tmp_path):
        from wittgenstein_tpu_torch.engine.checkpoint import CheckpointManager, read_manifest

        ck = str(tmp_path / "ck")
        trt.Supervisor(toy_chunk, t_toy(), n_chunks=4, checkpoint_dir=ck,
                       max_chunks_this_run=2).run()
        trt.Supervisor(toy_chunk, t_toy(), n_chunks=4, checkpoint_dir=ck).run()
        mgr = CheckpointManager(ck)
        meta = read_manifest(mgr.path_for(mgr.latest_step()))["meta"]
        assert meta["chunks_done"] == 4 and len(meta["chunk_seconds"]) == 4

    def test_toy_checkpoints_cross_the_packages(self, tmp_path):
        """A partial run checkpointed by one package resumes in the other
        to the same final state, under the same run id."""
        for first, second, toy1, toy2 in ((jrt, trt, j_toy, t_toy), (trt, jrt, t_toy, j_toy)):
            ck = str(tmp_path / first.__name__.split(".")[0])
            rep1 = first.Supervisor(toy_chunk, toy1(), n_chunks=5, checkpoint_dir=ck,
                                    run_key="toy:5", max_chunks_this_run=3).run()
            rep2 = second.Supervisor(toy_chunk, toy2(), n_chunks=5, checkpoint_dir=ck,
                                     run_key="toy:5").run()
            assert rep2.ok and rep2.provenance["resumed_from_step"] == 3
            assert rep2.provenance["run_id"] == rep1.provenance["run_id"]
            same_tree(toy_np(rep2.state), toy_np(t_after(5)))


# -- run identity ------------------------------------------------------------


class _FakeNet:
    protocol = object()


class TestStableRunKey:
    def test_stable_across_copies_and_shape_sensitive(self):
        k1 = trt.stable_run_key(_FakeNet(), t_toy(), 8, 50)
        assert k1 == trt.stable_run_key(_FakeNet(), t_toy(), 8, 50)
        assert k1 == jrt.stable_run_key(_FakeNet(), j_toy(), 8, 50)
        assert k1 != trt.stable_run_key(_FakeNet(), t_toy(), 4, 50)
        wider = {"x": torch.arange(8, dtype=torch.int32), "step": torch.tensor(0, dtype=torch.int32)}
        assert k1 != trt.stable_run_key(_FakeNet(), wider, 8, 50)

    def test_never_materializes_leaves(self):
        class ShapeOnly:
            shape = (4,)
            dtype = "int32"

            def __array__(self, *a, **k):  # pragma: no cover - the assertion
                raise AssertionError("run key must not read leaf values")

        key = trt.stable_run_key(_FakeNet(), {"x": ShapeOnly()}, 2, 10)
        assert "2x10ms" in key
        assert key == jrt.stable_run_key(_FakeNet(), {"x": ShapeOnly()}, 2, 10)

    def test_pingpong_literal(self):
        from wittgenstein_tpu_torch.protocols.pingpong_batched import make_pingpong

        net, s = make_pingpong(16, device="cpu")
        assert (trt.stable_run_key(net, replicate_state(s, 2), 3, 100)
                == "BatchedPingPong:3x100ms:8dd10c148098d53c")

    def test_handel_with_both_side_cars_equals_jax(self):
        from wittgenstein_tpu.faults import FaultPlan as JPlan
        from wittgenstein_tpu.profiling.ablation import flagship_params as jflag
        from wittgenstein_tpu.protocols.handel_batched import make_handel as jmake
        from wittgenstein_tpu.telemetry.state import TelemetryConfig as JTele
        from wittgenstein_tpu_torch.faults import FaultPlan
        from wittgenstein_tpu_torch.protocols.handel import flagship_params
        from wittgenstein_tpu_torch.protocols.handel_batched import make_handel
        from wittgenstein_tpu_torch.telemetry import TelemetryConfig

        jnet, js = jmake(jflag(32))
        jnet, js = jnet.with_faults(js, plan=JPlan("c").crash([3], at=10, recover=50))
        jnet, js = jnet.with_telemetry(js, JTele(snapshots=4, snapshot_every_ms=10))
        tnet, ts = make_handel(flagship_params(32), device="cpu")
        tnet, ts = tnet.with_faults(ts, plan=FaultPlan("c").crash([3], at=10, recover=50))
        tnet, ts = tnet.with_telemetry(ts, TelemetryConfig(snapshots=4, snapshot_every_ms=10))
        for r, n, ms in ((2, 4, 100), (3, 1, 20)):
            assert (trt.stable_run_key(tnet, replicate_state(ts, r), n, ms)
                    == jrt.stable_run_key(jnet, jreplicate(js, r), n, ms))

    def test_ethpow_equals_jax(self):
        from wittgenstein_tpu.protocols import ethpow_batched as jeth
        from wittgenstein_tpu.protocols.ethpow import ETHPoWParameters as JP
        from wittgenstein_tpu_torch.protocols import ethpow_batched as teth
        from wittgenstein_tpu_torch.protocols.ethpow import ETHPoWParameters as TP

        j = jeth.BatchedEthPow(JP(number_of_miners=4))
        t = teth.BatchedEthPow(TP(number_of_miners=4), device="cpu")
        assert (trt.stable_run_key(t, teth.replicate_ethpow(t.init_state(), 2), 2, 1000)
                == jrt.stable_run_key(j, jeth.replicate_ethpow(j.init_state(), 2), 2, 1000)
                == "BatchedEthPow:2x1000ms:b10d905b4289328e")


# -- real simulations --------------------------------------------------------


@pytest.fixture(scope="module")
def armed_pingpong():
    """PingPong at 32 nodes with a crash plan and the telemetry side-car,
    built by each package."""
    from wittgenstein_tpu.faults import FaultPlan as JPlan
    from wittgenstein_tpu.protocols.pingpong_batched import make_pingpong as jmake
    from wittgenstein_tpu.telemetry.state import TelemetryConfig as JTele
    from wittgenstein_tpu_torch.faults import FaultPlan
    from wittgenstein_tpu_torch.protocols.pingpong_batched import make_pingpong
    from wittgenstein_tpu_torch.telemetry import TelemetryConfig

    lat = "NetworkFixedLatency(100)"
    jnet, js = jmake(32, network_latency_name=lat)
    jnet, js = jnet.with_faults(js, plan=JPlan("crash5").crash([5], at=50, recover=150))
    jnet, js = jnet.with_telemetry(js, JTele(snapshots=4, snapshot_every_ms=100))
    tnet, ts = make_pingpong(32, network_latency_name=lat, device="cpu")
    tnet, ts = tnet.with_faults(ts, plan=FaultPlan("crash5").crash([5], at=50, recover=150))
    tnet, ts = tnet.with_telemetry(ts, TelemetryConfig(snapshots=4, snapshot_every_ms=100))
    return (jnet, js), (tnet, ts)


@pytest.fixture(scope="module")
def handel32():
    """Handel at 32 nodes x 2: the port's net and state, and the straight
    120-ms runs of both packages."""
    from wittgenstein_tpu.protocols.handel import HandelParameters as JP
    from wittgenstein_tpu.protocols.handel_batched import make_handel as jmake
    from wittgenstein_tpu_torch.protocols.handel import HandelParameters as TP
    from wittgenstein_tpu_torch.protocols.handel_batched import make_handel

    kw = dict(node_count=32, threshold=28, pairing_time=3, level_wait_time=20,
              extra_cycle=5, dissemination_period_ms=10, fast_path=5, nodes_down=0)
    jnet, js = jmake(JP(**kw))
    net, state = make_handel(TP(**kw), device="cpu")
    straight = state_to_numpy(net.run_ms_batched(replicate_state(state, 2), 120))
    return net, state, straight, jtree(jnet.run_ms_batched(jreplicate(js, 2), 120))


class TestKillAndResumeBitIdentity:
    TOTAL_MS, CHUNK_MS, REPLICAS = 400, 50, 2

    def _supervised(self, rt, rep_fn, net, state, **kw):
        return rt.Supervisor.from_network(
            net, rep_fn(state, self.REPLICAS), total_ms=self.TOTAL_MS,
            chunk_ms=self.CHUNK_MS, **kw).run()

    def test_interrupt_resume_bitwise_with_sidecars(self, armed_pingpong, tmp_path):
        (jnet, js), (tnet, ts) = armed_pingpong
        jref = self._supervised(jrt, jreplicate, jnet, js)
        ref = self._supervised(trt, replicate_state, tnet, ts)
        assert ref.ok and ref.chunks_done == 8
        ck = str(tmp_path / "ck")
        rep1 = self._supervised(trt, replicate_state, tnet, ts, checkpoint_dir=ck,
                                max_chunks_this_run=3)
        assert not rep1.ok and rep1.chunks_done == 3
        rep2 = self._supervised(trt, replicate_state, tnet, ts, checkpoint_dir=ck)
        assert rep2.ok and rep2.provenance["resumed_from_step"] == 3
        assert rep2.provenance["run_key"] == jref.provenance["run_key"]
        same_tree(state_to_numpy(ref.state), state_to_numpy(rep2.state))
        same_tree(jtree(jref.state), state_to_numpy(rep2.state))
        assert int(rep2.state.tele.delivered.sum()) > 0
        assert int(rep2.state.faults.dropped_by_fault.sum()) > 0

    def test_supervised_equals_manual_chunk_loop(self, armed_pingpong):
        _, (tnet, ts) = armed_pingpong
        s = replicate_state(ts, self.REPLICAS)
        for _ in range(self.TOTAL_MS // self.CHUNK_MS):
            s = tnet.run_ms_batched(s, self.CHUNK_MS)
        rep = self._supervised(trt, replicate_state, tnet, ts)
        same_tree(state_to_numpy(s), state_to_numpy(rep.state))

    @pytest.mark.parametrize("watchdog", [False, True])
    def test_tick_driven_chunked_equals_straight_and_jax(self, handel32, watchdog):
        """Handel is tick-driven: the supervised 3 x 40-ms pass equals the
        straight 120-ms run, the port's and the JAX package's."""
        net, state, straight, jstraight = handel32
        wd = trt.WatchdogPolicy(chunk_deadline_s=600.0) if watchdog else None
        rep = trt.Supervisor.from_network(net, replicate_state(state, 2), total_ms=120,
                                          chunk_ms=40, watchdog=wd).run()
        assert rep.ok
        same_tree(straight, state_to_numpy(rep.state))
        same_tree(jstraight, state_to_numpy(rep.state))

    def test_inference_mode_run_on_the_watchdog_thread(self, tmp_path):
        """A supervised run started under torch.inference_mode() (as the
        card's script runs everything) steps its inference tensors on the
        watchdog thread, checkpoints and resumes, equal to the plain run."""
        from wittgenstein_tpu_torch.protocols.handel import flagship_params
        from wittgenstein_tpu_torch.protocols.handel_batched import make_handel

        wd = trt.WatchdogPolicy(chunk_deadline_s=600.0)
        ck = str(tmp_path / "ck")
        before = _watchdog_threads()
        with torch.inference_mode():
            net, state = make_handel(flagship_params(32), device="cpu")
            states = replicate_state(state, 2)
            assert states.done_at.is_inference()
            straight = net.run_ms_batched(states, 120)
            rep1 = trt.Supervisor.from_network(net, states, total_ms=120, chunk_ms=40,
                                               watchdog=wd, checkpoint_dir=ck,
                                               max_chunks_this_run=1).run()
            rep2 = trt.Supervisor.from_network(net, states, total_ms=120, chunk_ms=40,
                                               watchdog=wd, checkpoint_dir=ck).run()
        assert not rep1.ok and rep2.ok and rep2.provenance["resumed_from_step"] == 1
        same_tree(state_to_numpy(straight), state_to_numpy(rep2.state))
        assert _gone(before)


def test_inplace_chunk_under_inference_mode_on_the_watchdog_thread():
    """A chunk function that updates its state in place, run under
    torch.inference_mode() with the watchdog armed: the worker thread
    enters the caller's mode, where an inference tensor may be updated."""
    def bump(s):
        s["x"].add_(1)
        s["step"].add_(1)
        return s

    with torch.inference_mode():
        rep = trt.Supervisor(bump, t_toy(), n_chunks=3,
                             watchdog=trt.WatchdogPolicy(chunk_deadline_s=30.0)).run()
    assert rep.ok and rep.state["x"].is_inference()
    assert rep.state["x"].tolist() == [3, 4, 5, 6] and int(rep.state["step"]) == 3


class TestSupervisorValidation:
    def test_bad_geometry_rejected(self):
        with pytest.raises(ValueError, match="n_chunks"):
            trt.Supervisor(toy_chunk, t_toy(), n_chunks=0)
        with pytest.raises(ValueError, match="checkpoint_every"):
            trt.Supervisor(toy_chunk, t_toy(), n_chunks=1, checkpoint_every=0)

    def test_from_network_requires_divisible_total(self):
        class FakeNet:
            protocol = object()
            run_ms_batched = staticmethod(lambda s, ms, swd: s)

        with pytest.raises(ValueError, match="multiple"):
            trt.Supervisor.from_network(FakeNet(), t_toy(), total_ms=250, chunk_ms=100)

    def test_from_network_accepts_donate_and_runs_eagerly(self):
        seen = []

        class FakeNet:
            protocol = object()

            @staticmethod
            def run_ms_batched(s, ms, swd):
                seen.append((ms, swd))
                return toy_chunk(s)

        rep = trt.Supervisor.from_network(FakeNet(), t_toy(), total_ms=300, chunk_ms=100,
                                          donate=True, stop_when_done=True).run()
        assert rep.ok and seen == [(100, True)] * 3
        same_tree(toy_np(rep.state), toy_np(t_after(3)))

    def test_budget_partial_stop(self):
        def slow(s):
            time.sleep(0.05)
            return toy_chunk(s)

        rep = trt.Supervisor(slow, t_toy(), n_chunks=50, budget_s=0.12).run()
        assert not rep.ok and 0 < rep.chunks_done < 50


class TestErrorTaxonomyExtensions:
    def test_supervisor_raises_poison_without_retry(self, tmp_path):
        for rt, toy in ((jrt, j_toy), (trt, t_toy)):
            calls = {"n": 0}

            def chunk(s, rt=rt):
                calls["n"] += 1
                raise rt.PoisonRowError("job-x", RuntimeError("poison"))

            sup = rt.Supervisor(chunk, toy(), n_chunks=3,
                                checkpoint_dir=str(tmp_path / rt.__name__.split(".")[0]),
                                retry=rt.RetryPolicy(max_attempts=3, backoff_base_s=0.0,
                                                     jitter_frac=0.0))
            with pytest.raises(rt.PoisonRowError):
                sup.run()
            assert calls["n"] == 1

    def test_tracer_records_chunks_and_failures(self):
        from wittgenstein_tpu_torch.telemetry.trace import SpanTracer, validate_chrome_trace

        calls = {"n": 0}

        def flaky(s):
            calls["n"] += 1
            if calls["n"] == 2:
                raise RuntimeError("CUDA out of memory. Tried to allocate 1.00 GiB")
            return toy_chunk(s)

        tracer = SpanTracer()
        rep = trt.Supervisor(flaky, t_toy(), n_chunks=2, tracer=tracer, sleep=lambda s: None,
                             retry=trt.RetryPolicy(max_attempts=3, backoff_base_s=0.0)).run()
        assert rep.ok and rep.provenance["retries"] == 1
        events = [e for e in tracer.events if e["ph"] != "M"]  # less the metadata
        assert [(e["ph"], e["name"]) for e in events] == [
            ("X", "chunk"), ("i", "chunk-failed"), ("X", "chunk")]  # chunk 1 replayed
        assert events[1]["args"]["kind"] == "transient"
        validate_chrome_trace(tracer.to_json())

    def test_failure_dumps_the_recorder_beside_the_checkpoints(self, tmp_path):
        from wittgenstein_tpu_torch.obs import DUMP_BASENAME, FlightRecorder, read_events

        def broken(s):
            raise ValueError("semantic bug")

        rec = FlightRecorder()
        ck = tmp_path / "ck"
        with pytest.raises(ValueError):
            trt.Supervisor(broken, t_toy(), n_chunks=2, checkpoint_dir=str(ck),
                           recorder=rec).run()
        kinds = [e["kind"] for e in read_events(str(ck / DUMP_BASENAME))]
        assert kinds == ["chunk-start", "failure"]


class TestSupervisorShouldStop:
    def test_stop_requested_parks_then_resume_completes(self, tmp_path):
        def make(pkg, tmp, r):
            stop = threading.Event()

            def chunk_then_stop(s):
                out = toy_chunk(s)
                stop.set()
                return out

            return (chunk_then_stop if r == 0 else toy_chunk), dict(
                n_chunks=4, checkpoint_dir=tmp, should_stop=stop.is_set)

        rep1, rep2 = both(make, tmp_path, runs=2)
        assert rep1.ok is False and rep1.chunks_done == 1
        assert rep2.ok is True
        same_tree(toy_np(rep2.state), toy_np(t_after(4)))

    def test_placement_gets_the_host_leaves(self, armed_pingpong, tmp_path):
        """A placement callable receives the anchor's numpy leaves (as
        interop.state_to_numpy gives them) and places them itself."""
        from wittgenstein_tpu_torch.interop import state_from_numpy

        _, (tnet, ts) = armed_pingpong
        seen = []

        def place(tree):
            seen.append(type(tree["proto"]).__name__)
            return state_from_numpy(tree, "cpu")

        states = replicate_state(ts, 2)
        ck = str(tmp_path / "ck")
        kw = dict(total_ms=100, chunk_ms=50, checkpoint_dir=ck, placement=place)
        trt.Supervisor.from_network(tnet, states, max_chunks_this_run=1, **kw).run()
        rep = trt.Supervisor.from_network(tnet, states, **kw).run()
        assert rep.ok and seen == ["dict", "dict"]  # a fresh run, then the resume
        plain = trt.Supervisor.from_network(tnet, states, total_ms=100, chunk_ms=50).run()
        same_tree(state_to_numpy(plain.state), state_to_numpy(rep.state))

    def test_no_stop_runs_to_completion(self, tmp_path):
        rep = trt.Supervisor(toy_chunk, t_toy(), n_chunks=3, checkpoint_dir=str(tmp_path / "ck"),
                             should_stop=lambda: False).run()
        assert rep.ok
        same_tree(toy_np(rep.state), toy_np(t_after(3)))


def test_chunk_time_histogram_equals_jax():
    for times in ([], [0.05], [0.05, 0.3, 0.7, 1.5, 3.0, 9.0, 29.0, 59.0, 119.0, 500.0]):
        assert trt.chunk_time_histogram(times) == jrt.chunk_time_histogram(times)
