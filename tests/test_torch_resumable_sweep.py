"""The port's resumable run_fault_sweep against the JAX package's.

Handel at 64 nodes with the telemetry side-car, a control plan and a
crash plan, 120 ms in 30-ms chunks: a sweep stopped after two chunks
(RunIncompleteError with its partial report) and re-invoked equals the
uninterrupted sweep, and both equal the JAX package's sweep in every
leaf and record.  A partial checkpoint directory written by the JAX
package resumes in the port to the JAX package's final state, and one
written by the port resumes in the JAX package.  A changed chunk size
refuses to resume; use_run_cache still raises, after the check that it
and checkpoint_dir exclude each other.
"""

import numpy as np
import pytest
import torch

from test_torch_supervisor import jtree, same_tree
from wittgenstein_tpu.faults import FaultPlan as JPlan
from wittgenstein_tpu.profiling.ablation import flagship_params as jflag
from wittgenstein_tpu.protocols.handel_batched import make_handel as jmake
from wittgenstein_tpu.runtime import RunIncompleteError as JIncomplete
from wittgenstein_tpu.scenarios.sweep import run_fault_sweep as jsweep
from wittgenstein_tpu.telemetry.state import TelemetryConfig as JTele
from wittgenstein_tpu_torch.faults import FaultPlan
from wittgenstein_tpu_torch.interop import state_to_numpy
from wittgenstein_tpu_torch.protocols.handel import flagship_params
from wittgenstein_tpu_torch.protocols.handel_batched import make_handel
from wittgenstein_tpu_torch.runtime import ResumeMismatchError, RunIncompleteError
from wittgenstein_tpu_torch.scenarios.sweep import run_fault_sweep

N, SIM_MS, CHUNK_MS = 64, 120, 30


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _plans(plan_cls):
    return [None, plan_cls("crash6@20").crash(list(range(6)), at=20, recover=80)]


@pytest.fixture(scope="module")
def nets():
    jnet, js = jmake(jflag(N), telemetry=JTele(snapshots=8, snapshot_every_ms=25))
    from wittgenstein_tpu_torch.telemetry import TelemetryConfig

    tnet, ts = make_handel(flagship_params(N), device="cpu",
                           telemetry=TelemetryConfig(snapshots=8, snapshot_every_ms=25))
    return (jnet, js), (tnet, ts)


@pytest.fixture(scope="module")
def reference(nets, tmp_path_factory):
    """Each package's uninterrupted resumable sweep."""
    (jnet, js), (tnet, ts) = nets
    base = tmp_path_factory.mktemp("ref")
    jout, jrec = jsweep(jnet, js, _plans(JPlan), SIM_MS, checkpoint_dir=str(base / "jax"),
                        chunk_ms=CHUNK_MS)
    tout, trec = run_fault_sweep(tnet, ts, _plans(FaultPlan), SIM_MS,
                                 checkpoint_dir=str(base / "torch"), chunk_ms=CHUNK_MS)
    return jtree(jout), jrec, state_to_numpy(tout), trec


def test_uninterrupted_equals_jax_and_the_plain_sweep(nets, reference):
    _, (tnet, ts) = nets
    jout, jrec, tout, trec = reference
    same_tree(jout, tout)
    assert trec == jrec
    plain, prec = run_fault_sweep(tnet, ts, _plans(FaultPlan), SIM_MS)
    same_tree(tout, state_to_numpy(plain))  # Handel is tick-driven
    assert prec == trec
    assert int(np.asarray(tout["faults"]["dropped_by_fault"]).sum()) > 0
    assert int(np.asarray(tout["tele"]["ticks"]).sum()) == 2 * SIM_MS


def test_interrupted_sweep_resumes_bitwise(nets, reference, tmp_path):
    _, (tnet, ts) = nets
    jout, jrec, tout, trec = reference
    ck = str(tmp_path / "ck")
    with pytest.raises(RunIncompleteError) as ei:
        run_fault_sweep(tnet, ts, _plans(FaultPlan), SIM_MS, checkpoint_dir=ck,
                        chunk_ms=CHUNK_MS, supervisor_kw={"max_chunks_this_run": 2})
    assert ei.value.report.chunks_done == 2 and not ei.value.report.ok
    out, records = run_fault_sweep(tnet, ts, _plans(FaultPlan), SIM_MS, checkpoint_dir=ck,
                                   chunk_ms=CHUNK_MS)
    same_tree(tout, state_to_numpy(out))
    same_tree(jout, state_to_numpy(out))
    assert records == trec == jrec


def test_jax_partial_checkpoint_resumes_in_the_port(nets, reference, tmp_path):
    (jnet, js), (tnet, ts) = nets
    jout, jrec, _, _ = reference
    ck = str(tmp_path / "ck")
    with pytest.raises(JIncomplete):
        jsweep(jnet, js, _plans(JPlan), SIM_MS, checkpoint_dir=ck, chunk_ms=CHUNK_MS,
               supervisor_kw={"max_chunks_this_run": 3})
    seen = []
    out, records = run_fault_sweep(
        tnet, ts, _plans(FaultPlan), SIM_MS, checkpoint_dir=ck, chunk_ms=CHUNK_MS,
        supervisor_kw={"heartbeat": lambda i, dt: seen.append(i)})
    assert seen == [3]  # resumed at step 3: one chunk left
    same_tree(jout, state_to_numpy(out))
    assert records == jrec


def test_port_partial_checkpoint_resumes_in_jax(nets, reference, tmp_path):
    (jnet, js), (tnet, ts) = nets
    jout, jrec, _, _ = reference
    ck = str(tmp_path / "ck")
    with pytest.raises(RunIncompleteError):
        run_fault_sweep(tnet, ts, _plans(FaultPlan), SIM_MS, checkpoint_dir=ck,
                        chunk_ms=CHUNK_MS, supervisor_kw={"max_chunks_this_run": 1})
    seen = []
    out, records = jsweep(jnet, js, _plans(JPlan), SIM_MS, checkpoint_dir=ck,
                          chunk_ms=CHUNK_MS,
                          supervisor_kw={"heartbeat": lambda i, dt: seen.append(i)})
    assert seen == [1, 2, 3]
    same_tree(jout, jtree(out))
    assert records == jrec


def test_changed_chunk_size_refuses_to_resume(nets, tmp_path):
    _, (tnet, ts) = nets
    ck = str(tmp_path / "ck")
    with pytest.raises(RunIncompleteError):
        run_fault_sweep(tnet, ts, _plans(FaultPlan), SIM_MS, checkpoint_dir=ck,
                        chunk_ms=CHUNK_MS, supervisor_kw={"max_chunks_this_run": 1})
    ran = []
    with pytest.raises(ResumeMismatchError):
        run_fault_sweep(tnet, ts, _plans(FaultPlan), SIM_MS, checkpoint_dir=ck, chunk_ms=60,
                        supervisor_kw={"heartbeat": lambda i, dt: ran.append(i)})
    assert ran == []


def test_argument_checks(nets, tmp_path):
    _, (tnet, ts) = nets
    with pytest.raises(ValueError, match="divide"):
        run_fault_sweep(tnet, ts, [None], SIM_MS, checkpoint_dir=str(tmp_path / "a"),
                        chunk_ms=50)
    with pytest.raises(ValueError, match="mutually exclusive"):
        run_fault_sweep(tnet, ts, [None], SIM_MS, checkpoint_dir=str(tmp_path / "b"),
                        use_run_cache=True)
    with pytest.raises(ValueError, match="stop_when_done"):
        run_fault_sweep(tnet, ts, [None], SIM_MS, use_run_cache=True, stop_when_done=True)
    with pytest.raises(NotImplementedError, match="Queue A 16"):
        run_fault_sweep(tnet, ts, [None], SIM_MS, use_run_cache=True)
