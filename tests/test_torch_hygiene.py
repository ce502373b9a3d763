"""The port stands alone: no JAX, nothing of the JAX package, CUDA by default.

wittgenstein_tpu_torch and chip_smoke.py must import neither `jax` nor
anything of `wittgenstein_tpu` (they run on machines without JAX), and
the port's entry points must run on CUDA unless asked for the CPU —
without a card they raise instead of quietly running on the CPU.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import wittgenstein_tpu_torch
from wittgenstein_tpu_torch.core.registries import registry_network_latencies
from wittgenstein_tpu_torch.engine import BatchedNetwork, BatchedProtocol
from wittgenstein_tpu_torch.protocols.handel import HandelParameters, flagship_params
from wittgenstein_tpu_torch.protocols.casper_batched import make_casper
from wittgenstein_tpu_torch.protocols.dfinity_batched import make_dfinity
from wittgenstein_tpu_torch.protocols.enr_batched import make_enr
from wittgenstein_tpu_torch.protocols.gsf import GSFSignatureParameters
from wittgenstein_tpu_torch.protocols.gsf_batched import make_gsf
from wittgenstein_tpu_torch.protocols.handeleth2 import HandelEth2Parameters
from wittgenstein_tpu_torch.protocols.handeleth2_batched import make_handeleth2
from wittgenstein_tpu_torch.protocols.handel_batched import BatchedHandel, make_handel
from wittgenstein_tpu_torch.protocols.p2phandel import P2PHandelParameters
from wittgenstein_tpu_torch.protocols.p2phandel_batched import make_p2phandel
from wittgenstein_tpu_torch.protocols.paxos_batched import make_paxos
from wittgenstein_tpu_torch.protocols.pingpong_batched import make_pingpong
from wittgenstein_tpu_torch.protocols.sanfermin import SanFerminSignatureParameters
from wittgenstein_tpu_torch.protocols.sanfermin_batched import make_sanfermin
from wittgenstein_tpu_torch.protocols.avalanche_batched import make_slush, make_snowflake
from wittgenstein_tpu_torch.protocols.optimistic_p2p_signature import (
    OptimisticP2PSignatureParameters,
)
from wittgenstein_tpu_torch.protocols.optimistic_p2p_signature_batched import make_optimistic
from wittgenstein_tpu_torch.protocols.p2pflood_batched import make_p2pflood
from wittgenstein_tpu_torch.protocols.sanfermin_cappos import SanFerminParameters
from wittgenstein_tpu_torch.protocols.sanfermin_cappos_batched import make_sanfermin_cappos
from wittgenstein_tpu_torch.telemetry import TelemetryConfig

ROOT = Path(__file__).resolve().parent.parent
PKG = Path(wittgenstein_tpu_torch.__file__).resolve().parent
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _module_names():
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_import_loads_no_jax():
    mods = list(_module_names()) + ["chip_smoke"]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'wittgenstein_tpu' or m.startswith('wittgenstein_tpu.'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stdout + res.stderr


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "wittgenstein_tpu"), (
            f"{path.relative_to(ROOT)} imports {mod}"
        )


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = HandelParameters(node_count=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_handel(params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedNetwork(BatchedHandel(params), registry_network_latencies.get_by_name(None), 64)
    for make in (make_pingpong, make_dfinity, make_casper, make_paxos, make_slush,
                 make_snowflake, make_p2pflood, make_enr):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    # asking for the CPU is the one way to run without a card
    net, state = make_handel(params, device="cpu")
    assert net.device.type == "cpu" and state.done_at.device.type == "cpu"
    assert not net.protocol.SCORE_CACHE  # the CPU default arm


@pytest.mark.parametrize("make, params", [
    (make_gsf, GSFSignatureParameters(node_count=64)),
    (make_p2phandel, P2PHandelParameters(signing_node_count=24, relaying_node_count=8,
                                         connection_count=6)),
    (make_handeleth2, HandelEth2Parameters(node_count=16)),
    (make_sanfermin, SanFerminSignatureParameters(64, 64, 2, 48, 300, 1, False, None, None)),
    (make_optimistic, OptimisticP2PSignatureParameters(64, 56, 10, 1)),
    (make_sanfermin_cappos, SanFerminParameters(64, 32, 2, 48, 150, 4)),
], ids=["make_gsf", "make_p2phandel", "make_handeleth2", "make_sanfermin", "make_optimistic",
        "make_sanfermin_cappos"])
def test_aggregation_entry_points_default_to_cuda(monkeypatch, make, params):
    """GSF, P2PHandel, HandelEth2, SanFermin, OptimisticP2PSignature and
    SanFerminCappos: CUDA unless asked for the CPU, and without a card the default raises instead of running on the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make(params)
    net, state = make(params, device="cpu")
    assert net.device.type == "cpu" and state.done_at.device.type == "cpu"
    assert all(v.device.type == "cpu" for v in state.proto.values())


class _CoarseProbe(BatchedProtocol):
    TICK_INTERVAL = None
    TIME_QUANTUM = 1024


class _EveryFiveMs(BatchedProtocol):
    TICK_INTERVAL = 5


def test_unported_engine_options_raise():
    """What the port still leaves out raises: tick intervals other than 1
    and None; a telemetry or fault switch that is not a TelemetryConfig or
    a FaultConfig is refused; a quantum wider than the wheel fails as in
    the JAX package."""
    proto = BatchedHandel(flagship_params(64))
    lat = registry_network_latencies.get_by_name(None)
    for p, kw, exc in (
        (proto, dict(telemetry=object()), TypeError),
        (proto, dict(faults=object()), TypeError),
        (_EveryFiveMs(), {}, NotImplementedError),
        (_CoarseProbe(), dict(wheel_rows=512), ValueError),
    ):
        with pytest.raises(exc):
            BatchedNetwork(p, lat, 64, device="cpu", **kw)
    # the wheel, the consensus-jump switch, the telemetry side-car and the
    # throughput and discard-time options are ported
    BatchedNetwork(proto, lat, 64, device="cpu", wheel_rows=512, batched_jumps=True)
    BatchedNetwork(proto, lat, 64, device="cpu", telemetry=TelemetryConfig(snapshots=4))
    from wittgenstein_tpu_torch.core.throughput import MathisNetworkThroughput

    BatchedNetwork(proto, lat, 64, device="cpu", msg_discard_time=500,
                   throughput=MathisNetworkThroughput(lat, 1 << 16))


def test_telemetry_entry_points_default_to_cuda(monkeypatch):
    """The entry points that take `telemetry=` (make_handel, make_pingpong,
    make_p2pflood) and the telemetry modules: CUDA unless asked for the
    CPU, and without a card the default raises; every telemetry module is
    among the sources held free of JAX imports."""
    cfg = TelemetryConfig(snapshots=8, snapshot_every_ms=5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda **kw: make_handel(HandelParameters(node_count=64), **kw),
                 make_pingpong, make_p2pflood):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(telemetry=cfg)
        net, state = make(telemetry=cfg, device="cpu")
        assert net.telemetry == cfg
        assert all(a.device.type == "cpu" for a in state.tele)
        assert state.tele.snap_time.shape == (8,)
    names = {p.name for p in SOURCES if p.parent.name == "telemetry"}
    assert names == {"__init__.py", "state.py", "export.py", "trace.py", "phases.py"}


def test_new_entry_points_default_to_cuda(monkeypatch):
    """ETHPoW, its miner environment, the attack environment and a fault
    plan's lowering: CUDA unless asked for the CPU, and without a card the
    default raises."""
    from wittgenstein_tpu_torch.faults import FaultPlan, lower_plans
    from wittgenstein_tpu_torch.protocols.ethpow import ETHPoWParameters
    from wittgenstein_tpu_torch.protocols.ethpow_batched import BatchedEthPow
    from wittgenstein_tpu_torch.protocols.ethpow_env import BatchedMinerEnv
    from wittgenstein_tpu_torch.protocols.handel_env import BatchedAttackEnv

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    agent = ETHPoWParameters(number_of_miners=10, byz_class_name="ETHMinerAgent",
                             byz_mining_ratio=0.45)
    for build in (lambda **kw: BatchedEthPow(ETHPoWParameters(number_of_miners=3), **kw),
                  lambda **kw: BatchedMinerEnv(agent, **kw),
                  lambda **kw: BatchedAttackEnv(**kw),
                  lambda **kw: FaultPlan("x").drop(5).lower(8, 2, **kw),
                  lambda **kw: lower_plans([None], 8, 2, **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
        build(device="cpu")
    net = BatchedEthPow(ETHPoWParameters(number_of_miners=3), device="cpu")
    assert net.init_state().arrival.device.type == "cpu"


def test_port_data_is_its_own():
    """The CITIES builder reads the port's own city tables (names,
    positions and populations), the city-matrix models the port's own copy
    of the ping matrix (`data/city_latency.npz`), the regression replays
    the port's own copies of the two pinned champions
    (`scenarios/regressions/*.json`), and no port source names a file of
    the JAX package (checkpoints are npz files by format)."""
    from wittgenstein_tpu_torch.core import geo
    from wittgenstein_tpu_torch.tools import latency_csv

    data = PKG / "data" / "cities.json"
    assert geo._CITIES_JSON == data and data.is_file()
    assert data.stat().st_size < 16_000
    assert len(geo.latency_cities()) == 219
    assert len(geo.GeoAllCities().cities_position()) == 241
    assert latency_csv.BAKED == PKG / "data" / "city_latency.npz" and latency_csv.BAKED.is_file()
    assert latency_csv.BAKED.stat().st_size < 200_000
    from wittgenstein_tpu_torch.scenarios import regressions

    assert regressions.REGRESSIONS_DIR == PKG / "scenarios" / "regressions"
    pins = regressions.list_regressions()
    assert [p.name for p in pins] == ["handel_es_s0.json", "p2pflood_es_s0.json"]
    assert all(p.is_file() and p.stat().st_size < 16_000 for p in pins)
    for path in SOURCES:
        text = path.read_text()
        for needle in ("wittgenstein_tpu/data", "wittgenstein_tpu.data"):
            assert needle not in text, f"{path.relative_to(ROOT)} names {needle!r}"
        assert ".npz" not in text or path.name in ("latency_csv.py", "checkpoint.py"), path.name


def test_sweep_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """The sweep runner, the Handel batteries and their command line, and
    the batched-protocol registry's factories: CUDA unless asked for the
    CPU, and without a card the default raises; the new modules are among
    the sources held free of JAX imports."""
    from wittgenstein_tpu_torch.core.registries import registry_batched_protocols
    from wittgenstein_tpu_torch.scenarios import handel_scenarios
    from wittgenstein_tpu_torch.scenarios.sweep import run_sweep

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    configs = handel_scenarios.desync_configs(16)[:1]
    for run in (lambda: run_sweep(configs, replicas=1, sim_ms=5),
                lambda: handel_scenarios.run_scenario("desync", 16, 1, 5),
                lambda: handel_scenarios.main(["desync", "--nodes", "16", "--sim-ms", "5"]),
                lambda: registry_batched_protocols.get("pingpong").factory()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()
    out = tmp_path / "desync.csv"
    handel_scenarios.main(["desync", "--nodes", "16", "--replicas", "1", "--sim-ms", "5",
                           "--device", "cpu", "--out", str(out)])
    assert out.read_text().startswith("desync\nid,nodes,value,")
    net, _ = registry_batched_protocols.get("pingpong").factory(device="cpu")
    assert net.device.type == "cpu"
    names = {str(p.relative_to(PKG)) for p in SOURCES if p.parent.name in ("scenarios", "tools")}
    assert names == {"scenarios/__init__.py", "scenarios/sweep.py",
                     "scenarios/handel_scenarios.py", "scenarios/regressions.py",
                     "tools/__init__.py", "tools/latency_csv.py", "tools/csv_formatter.py",
                     "tools/graph.py", "tools/fault_sweep.py", "tools/profiling.py",
                     "tools/node_drawer.py"}


def test_search_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """The search driver, the regression replay and the fault-sweep
    command line: CUDA unless asked for the CPU, and without a card the
    default raises; the search, checkpoint, recorder and lock modules, and
    the supervisor with its taxonomy, policies and monitors, are among the
    sources held free of JAX imports."""
    from wittgenstein_tpu_torch.scenarios.regressions import (
        REGRESSIONS_DIR,
        load_regression,
        verify_regression,
    )
    from wittgenstein_tpu_torch.search import SearchConfig, SearchDriver
    from wittgenstein_tpu_torch.tools import fault_sweep

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = SearchConfig(protocol="p2pflood", sim_ms=50, generations=1, population=2)
    doc = load_regression(REGRESSIONS_DIR / "p2pflood_es_s0.json")
    for run in (lambda: SearchDriver(cfg),
                lambda: verify_regression(doc),
                lambda: fault_sweep.main([str(tmp_path / "static")]),
                lambda: fault_sweep.main([str(tmp_path / "search"), "--search"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()
    driver = SearchDriver(cfg, device="cpu")
    assert driver.net.device.type == "cpu" and driver.state.down.device.type == "cpu"
    names = {str(p.relative_to(PKG)) for p in SOURCES
             if p.parent.name in ("search", "obs", "runtime") or p.name == "checkpoint.py"}
    assert names == {"search/__init__.py", "search/genome.py", "search/objectives.py",
                     "search/optimizers.py", "search/driver.py", "obs/__init__.py",
                     "obs/context.py", "obs/recorder.py", "obs/attribution.py",
                     "obs/monitor.py", "obs/timeseries.py", "obs/slo.py",
                     "runtime/__init__.py", "runtime/locks.py", "runtime/errors.py",
                     "runtime/policy.py", "runtime/supervisor.py", "engine/checkpoint.py"}


def test_serving_entry_points_default_to_cuda(monkeypatch):
    """The batch scheduler and the device groups: CUDA unless asked for
    the CPU, and without a card the default raises; the serving and run
    cache modules are among the sources held free of JAX imports."""
    from wittgenstein_tpu_torch.parallel import make_device_groups
    from wittgenstein_tpu_torch.serve import BatchScheduler

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchScheduler(auto_start=False)
    with pytest.raises(ValueError, match="no devices visible"):
        make_device_groups(1)
    assert BatchScheduler(auto_start=False, device="cpu").device.type == "cpu"
    names = {str(p.relative_to(PKG)) for p in SOURCES
             if p.parent.name in ("serve", "parallel")}
    assert names == {"serve/__init__.py", "serve/jobs.py", "serve/metrics.py",
                     "serve/scheduler.py", "parallel/__init__.py",
                     "parallel/device_groups.py", "parallel/replica_shard.py",
                     "parallel/exchange.py", "parallel/mesh2d.py", "parallel/node_shard.py"}


def test_profiling_entry_points_default_to_cuda(monkeypatch):
    """The ablation matrix and a recorded call run on CUDA unless asked
    for the CPU, and without a card the default raises; the memory model
    sizes against the card only when the state lies on one; the
    profiling, throughput and tool modules are among the sources held
    free of JAX imports; the package surface exports the JAX package's
    names where the port has the function."""
    from wittgenstein_tpu_torch import ops, runtime, scenarios
    from wittgenstein_tpu_torch.profiling import ablation_matrix, record_call, replicas_per_chip

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (lambda: ablation_matrix(16, levers=["base"]),
                lambda: record_call(lambda: None)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()
    _, state = make_handel(HandelParameters(node_count=16), device="cpu")
    with pytest.raises(ValueError, match="pass hbm_gib"):
        replicas_per_chip(state)
    assert replicas_per_chip(state, hbm_gib=1.0)["replicas"] > 0
    names = {str(p.relative_to(PKG)) for p in SOURCES
             if p.parent.name == "profiling" or p.name in ("throughput.py", "profiling.py")}
    assert names == {"profiling/__init__.py", "profiling/ablation.py", "profiling/budget.py",
                     "profiling/hbm.py", "profiling/probe.py", "profiling/xla_cost.py",
                     "core/throughput.py", "tools/profiling.py"}
    assert {"verify_regression", "pin_regression", "load_regression", "list_regressions",
            "check_regression_doc", "SCHEMA", "REGRESSIONS_DIR"} <= set(scenarios.__all__)
    assert {"yield_point", "set_interleave", "YIELD_POINTS"} <= set(runtime.__all__)
    assert set(ops.__all__) == {"popcount_words", "xor_shuffle", "block_mask",
                                "level_block_mask"}
    for mod in (scenarios, runtime, ops):
        assert all(hasattr(mod, name) for name in mod.__all__), mod.__name__


def test_contract_entry_points_default_to_cuda(monkeypatch):
    """The contract checks (check_all, audit_all, the other passes, the
    command line's run) and anim_frames: CUDA unless asked for the CPU,
    and without a card the default raises; the analysis modules and the
    node drawer are among the sources held free of JAX imports."""
    from wittgenstein_tpu_torch.analysis import cli
    from wittgenstein_tpu_torch.analysis.checkpoint_check import check_checkpoints
    from wittgenstein_tpu_torch.analysis.contracts import check_all
    from wittgenstein_tpu_torch.analysis.regressions_check import check_regressions
    from wittgenstein_tpu_torch.analysis.rng_audit import audit_all
    from wittgenstein_tpu_torch.analysis.serve_check import check_serve_scheduler
    from wittgenstein_tpu_torch.scenarios.handel_scenarios import anim_frames

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (lambda: check_all(names=["pingpong"]), lambda: audit_all(names=["pingpong"]),
                lambda: check_checkpoints(names=["pingpong"]),
                lambda: check_serve_scheduler(), lambda: check_regressions(str(ROOT), lower=True),
                lambda: cli.run(str(ROOT), protocols=["pingpong"]),
                lambda: cli.main(["--root", str(ROOT), "--protocol", "pingpong"]),
                lambda: anim_frames(16, 20)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()
    assert check_all(names=["pingpong"], device="cpu") == []
    assert next(anim_frames(16, 20, device="cpu"))[0] == 10
    names = {str(p.relative_to(PKG)) for p in SOURCES if p.parent.name == "analysis"}
    assert names == {"analysis/__init__.py", "analysis/__main__.py", "analysis/findings.py",
                     "analysis/contracts.py", "analysis/rng_audit.py",
                     "analysis/checkpoint_check.py", "analysis/serve_check.py",
                     "analysis/regressions_check.py", "analysis/registry_check.py",
                     "analysis/mesh_check.py", "analysis/cli.py"}


def test_world_map_is_its_own():
    """The node drawer reads the port's own copy of the world map, a byte
    copy of the JAX package's, and imports PIL only when it draws."""
    from wittgenstein_tpu_torch.tools import node_drawer

    assert node_drawer.WORLD_MAP == PKG / "data" / "world_map_2000px.png"
    assert node_drawer.WORLD_MAP.is_file()
    assert node_drawer.WORLD_MAP.read_bytes() == (
        ROOT / "wittgenstein_tpu" / "data" / "world_map_2000px.png").read_bytes()
    body = ast.parse((PKG / "tools" / "node_drawer.py").read_text()).body
    top = {a.name for n in body if isinstance(n, ast.Import) for a in n.names}
    top |= {n.module for n in body if isinstance(n, ast.ImportFrom) and n.module}
    assert not any(m.split(".")[0] == "PIL" for m in top)
    assert any(m.split(".")[0] == "PIL"
               for m in _imported_modules(PKG / "tools" / "node_drawer.py"))
