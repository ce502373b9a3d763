"""The port's pinned p2pflood champion and the regression audit.

The port's `scenarios/regressions/p2pflood_es_s0.json` is a byte copy of
the JAX package's pin (its ES campaign's champion over the registry's
P2PFlood at 1000 ms), and replays in the port on the CPU to its pinned
score, 1559.1, with the static baselines re-scored to exactly the pinned
values.  `check_regression_doc` finds what the JAX package's finds on
the same broken documents, and `load_regression` refuses another schema
with the same message.
"""

import copy
import json
from pathlib import Path

import pytest
import torch

from wittgenstein_tpu.scenarios import regressions as jreg
from wittgenstein_tpu_torch.scenarios import regressions as treg

NAME = "p2pflood_es_s0.json"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_pins_are_byte_copies():
    assert [p.name for p in treg.list_regressions()] == [p.name for p in jreg.list_regressions()]
    for p in treg.list_regressions():
        assert p.read_bytes() == (jreg.REGRESSIONS_DIR / p.name).read_bytes(), p.name
    assert treg.REGRESSIONS_DIR.parent == Path(treg.__file__).resolve().parent


def test_pin_replays_to_its_value():
    doc = treg.load_regression(treg.REGRESSIONS_DIR / NAME)
    out = treg.verify_regression(treg.REGRESSIONS_DIR / NAME, device="cpu")
    assert out["objective_value"] == doc["objective_value"] == 1559.1
    assert out["plan_digest"] == doc["plan_digest"] == "3f97e845d9ee79b96452813100a8a389"
    assert out["baseline_scores"] == doc["baseline"]["scores"]
    assert out["baseline_scores"] == {"control": 736.0, "crash20@200": 939.0, "drop30%": 801.0,
                                      "slow3x": 1043.2, "split@100-600": 1141.7}
    assert out["record"]["availability"] == doc["availability"]


def _broken():
    doc = json.loads((treg.REGRESSIONS_DIR / NAME).read_text())
    cases = {}
    for key in ("schema", "plan_digest", "genome"):
        d = copy.deepcopy(doc)
        del d[key]
        cases[f"missing_{key}"] = d
    edits = {
        "schema": lambda d: d.update(schema="witt-regression/v0"),
        "protocol": lambda d: d.update(protocol="nope"),
        "objective": lambda d: d.update(objective="nope"),
        "sim_ms": lambda d: d.update(sim_ms=1.5),
        "rpp": lambda d: d.update(replicas_per_plan=0),
        "genome_shape": lambda d: d["genome"].update(vec=d["genome"]["vec"][:-1]),
        "genome_bounds": lambda d: d["genome"]["vec"].__setitem__(0, 9.0),
        "genome_keys": lambda d: d.update(genome={"vec": []}),
        "baseline_empty": lambda d: d["baseline"].update(scores={}),
        "baseline_beats": lambda d: d["baseline"]["scores"].update(control=2000.0),
    }
    for name, edit in edits.items():
        d = copy.deepcopy(doc)
        edit(d)
        cases[name] = d
    return cases


BROKEN = _broken()


@pytest.mark.parametrize("case", list(BROKEN))
def test_structural_findings_match(case):
    doc = BROKEN[case]
    got = treg.check_regression_doc(copy.deepcopy(doc))
    assert got and got == jreg.check_regression_doc(copy.deepcopy(doc))


def test_clean_docs_and_schema_refusal(tmp_path):
    for p in treg.list_regressions():
        assert treg.check_regression_doc(treg.load_regression(p)) == []
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": "other"}))
    with pytest.raises(ValueError) as te:
        treg.load_regression(bad)
    with pytest.raises(ValueError) as je:
        jreg.load_regression(bad)
    assert str(te.value) == str(je.value)
    with pytest.raises(AssertionError, match="structurally invalid"):
        treg.verify_regression(BROKEN["protocol"], device="cpu")
    assert treg.list_regressions(tmp_path / "none") == []
