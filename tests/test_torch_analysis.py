"""The port's checkpoint, RNG, serve, regression and registry passes, and
the command line that runs them with the contract checks.

Each pass is clean over the real tree on the CPU and flags a seeded
defect: SL405 a lying beat (test_torch_contract_defects.py), SL501 a
lossy save and a stale EPHEMERAL_LEAVES declaration, SL801 a scheduler
that rebuilds its families every dispatch, SL1401 a tampered pin at
either depth, SL301 an unregistered, untested protocol module.  The
command line's exit codes and JSONL mirror the JAX package's
(tests/test_simlint.py::test_cli_exit_codes_and_jsonl).
"""

import json
import pathlib
import shutil

import pytest
import torch

from wittgenstein_tpu_torch.analysis import RULES, Finding, Severity
from wittgenstein_tpu_torch.analysis import cli
from wittgenstein_tpu_torch.analysis.checkpoint_check import (
    check_checkpoints,
    check_entry_checkpoint,
)
from wittgenstein_tpu_torch.analysis.regressions_check import check_regressions
from wittgenstein_tpu_torch.analysis.registry_check import check_registry_coverage
from wittgenstein_tpu_torch.analysis.rng_audit import audit_all
from wittgenstein_tpu_torch.analysis.serve_check import check_serve_scheduler
from wittgenstein_tpu_torch.core.registries import BatchedProtocolEntry
from wittgenstein_tpu_torch.engine import checkpoint as ck
from wittgenstein_tpu_torch.protocols.pingpong_batched import make_pingpong
from wittgenstein_tpu_torch.serve import BatchScheduler

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
PINS = REPO_ROOT / "wittgenstein_tpu_torch" / "scenarios" / "regressions"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _pingpong_entry():
    def factory(device=None):
        return make_pingpong(32, device=device)

    return BatchedProtocolEntry("pp32", "pingpong_batched", factory)


def test_catalog_and_json_round_trip():
    assert set(RULES) == {"SL301", "SL401", "SL402", "SL403", "SL404", "SL405", "SL406",
                          "SL407", "SL501", "SL701", "SL801", "SL901", "SL1201", "SL1401"}
    f = Finding("SL402", "a/b.py", 7, "msg", Severity.ERROR)
    d = json.loads(f.to_json())
    assert d["rule"] == "SL402" and d["line"] == 7 and d["summary"] == RULES["SL402"]
    assert Finding.from_dict(d) == f


def test_rng_audit_clean():
    assert audit_all(device="cpu") == []


def test_sl501_clean():
    findings = check_checkpoints(root=str(REPO_ROOT), device="cpu")
    assert findings == [], "\n".join(f.format() for f in findings)


def test_sl501_detects_lossy_save_and_stale_declaration(monkeypatch):
    orig = ck.save_state

    def lossy(state, dest, meta=None):
        # forgets the protocol's leaf
        return orig(state._replace(proto={}), dest, meta)

    monkeypatch.setattr(ck, "save_state", lossy)
    findings = check_entry_checkpoint(_pingpong_entry(), device="cpu")
    assert {f.rule for f in findings} == {"SL501"}
    assert any("'proto/pong' is not persisted" in f.message for f in findings), findings
    # declared ephemeral, the leaf is restored from the template and the
    # round trip holds
    monkeypatch.setattr(ck, "EPHEMERAL_LEAVES", frozenset({"proto/pong"}))
    assert check_entry_checkpoint(_pingpong_entry(), device="cpu") == []
    # a declaration naming no leaf is stale
    monkeypatch.setattr(ck, "save_state", orig)
    monkeypatch.setattr(ck, "EPHEMERAL_LEAVES", frozenset({"proto/no_such_leaf"}))
    findings = check_entry_checkpoint(_pingpong_entry(), device="cpu")
    assert findings and all("EPHEMERAL_LEAVES declares 'proto/no_such_leaf'" in f.message
                            for f in findings)


def test_ephemeral_leaf_loads_from_the_template(tmp_path, monkeypatch):
    """load_state fills a declared ephemeral leaf missing from the file
    from the template, as the JAX package's load_state does."""
    net, state = make_pingpong(32, device="cpu")
    dest = str(tmp_path / "s.ckpt")
    ck.save_state(state._replace(proto={}), dest)
    with pytest.raises(ck.CheckpointMissingLeafError):
        ck.load_state(state, dest)
    monkeypatch.setattr(ck, "EPHEMERAL_LEAVES", frozenset({"proto/pong"}))
    got = ck.load_state(state, dest)
    assert torch.equal(got.proto["pong"], state.proto["pong"])


def test_sl801_clean():
    findings = check_serve_scheduler(root=str(REPO_ROOT), device="cpu")
    assert findings == [], "\n".join(f.format() for f in findings)
    assert check_serve_scheduler(names=["Handel"], device="cpu") == []


def test_sl801_detects_a_program_per_batch():
    class Rebuilding(BatchScheduler):
        # forgets its families between dispatches: every batch builds a
        # new engine, so an identical second wave misses the run cache
        def drain_once(self, lane=None):
            self._families.clear()
            return super().drain_once(lane)

    findings = check_serve_scheduler(device="cpu", scheduler_cls=Rebuilding)
    assert [f.rule for f in findings] == ["SL801"]
    assert "re-dispatching an identical workload" in findings[0].message


def _pin_tree(tmp_path) -> pathlib.Path:
    root = tmp_path / "tree"
    shutil.copytree(PINS, root / "wittgenstein_tpu_torch" / "scenarios" / "regressions")
    return root


def test_sl1401_clean_at_both_depths():
    assert check_regressions(str(REPO_ROOT), lower=False) == []
    assert check_regressions(str(REPO_ROOT), lower=True, device="cpu") == []


def test_sl1401_detects_tampered_pins(tmp_path):
    root = _pin_tree(tmp_path)
    reg = root / "wittgenstein_tpu_torch" / "scenarios" / "regressions"
    # a pin whose plan digest no longer matches its genome: lowering depth
    doc = json.loads((reg / "p2pflood_es_s0.json").read_text())
    doc["plan_digest"] = "0" * 32
    (reg / "p2pflood_es_s0.json").write_text(json.dumps(doc))
    # a pin naming an unregistered protocol: structural depth
    doc = json.loads((reg / "handel_es_s0.json").read_text())
    doc["protocol"] = "no_such_protocol"
    (reg / "handel_es_s0.json").write_text(json.dumps(doc))
    (reg / "broken.json").write_text("{")
    shallow = check_regressions(str(root), lower=False)
    assert {pathlib.Path(f.path).name for f in shallow} == {"handel_es_s0.json", "broken.json"}
    deep = check_regressions(str(root), lower=True, device="cpu")
    assert {f.rule for f in deep} == {"SL1401"}
    assert any("lowered-plan digest" in f.message and f.path.endswith("p2pflood_es_s0.json")
               for f in deep)
    assert len(deep) == len(shallow) + 1


def test_sl301_clean_and_detects_an_unregistered_module(tmp_path):
    findings = check_registry_coverage(str(REPO_ROOT))
    assert findings == [], "\n".join(f.format() for f in findings)
    pkg = tmp_path / "wittgenstein_tpu_torch" / "protocols"
    pkg.mkdir(parents=True)
    for mod in ("pingpong_batched", "bad_batched"):
        (pkg / f"{mod}.py").write_text("")
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests" / "test_torch_pp.py").write_text("import pingpong_batched\n")
    msgs = [f.message for f in check_registry_coverage(str(tmp_path))]
    assert all(f.rule == "SL301" for f in check_registry_coverage(str(tmp_path)))
    assert any("bad_batched.py is not registered" in m for m in msgs)
    assert any("bad_batched.py has no tests/test_torch_*.py" in m for m in msgs)
    assert not any("pingpong_batched.py" in m for m in msgs)
    assert any("registry lists module 'paxos_batched'" in m for m in msgs)


def test_cli_exit_codes_and_jsonl(tmp_path, capsys):
    """End-to-end command line on a synthetic bad tree: exit 1, JSONL
    out; an empty valid tree exits 0; a missing package exits 2."""
    pkg = tmp_path / "wittgenstein_tpu_torch" / "protocols"
    pkg.mkdir(parents=True)
    (pkg / "bad_batched.py").write_text("class P:\n    pass\n")
    out = tmp_path / "findings.jsonl"
    rc = cli.main(["--root", str(tmp_path), "--strict", "--skip-contracts", "--device", "cpu",
                   "-o", str(out)])
    text = capsys.readouterr().out
    assert rc == 1
    rules = {json.loads(ln)["rule"] for ln in out.read_text().splitlines()}
    assert rules == {"SL301"}
    assert "bad_batched.py" in text
    rc = cli.main(["--root", str(tmp_path), "--skip-contracts", "--device", "cpu",
                   "--format", "json"])
    lines = capsys.readouterr().out.splitlines()
    assert rc == 1 and lines and all(json.loads(ln)["rule"] == "SL301" for ln in lines)

    bare = tmp_path / "clean"
    (bare / "wittgenstein_tpu_torch").mkdir(parents=True)
    (bare / "wittgenstein_tpu_torch" / "__init__.py").write_text("")
    assert cli.main(["--root", str(bare), "--strict", "--skip-contracts", "--device",
                     "cpu"]) == 0
    capsys.readouterr()
    assert cli.main(["--root", str(tmp_path / "nope"), "--device", "cpu"]) == 2
    capsys.readouterr()


def test_cli_full_run_clean(capsys):
    """Every pass over the real tree, one protocol and every one: clean,
    exit 0, each pass timed."""
    stats = {}
    assert cli.run(str(REPO_ROOT), device="cpu", stats=stats) == []
    assert list(stats) == list(cli.PASSES)
    assert stats["contracts"]["entries"] == 16 and stats["regressions"]["entries"] == 2
    assert all(s["seconds"] >= 0 for s in stats.values())
    assert cli.main(["--root", str(REPO_ROOT), "--device", "cpu", "--strict",
                     "--protocol", "pingpong"]) == 0
    assert "clean" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="unknown protocol"):
        cli.run(str(REPO_ROOT), device="cpu", protocols=["nope"])
