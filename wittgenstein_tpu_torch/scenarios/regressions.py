"""Pinned adversary regressions: every discovered attack stays a test.

When the search driver (search/driver.py) finds a FaultPlan that beats
the static baselines, `pin_regression` freezes it as a
`witt-regression/v1` JSON file: the GENOME (vector + gene-spec bounds),
the lowered-plan digest, the seed its rows ran with, the objective value
it scored, and the baseline scores it strictly beat.  The file is the
attack's complete identity — everything else (node population, live
mask, network) rebuilds from the registered protocol factory, which is
why `protocol` must name a `core.registries.registry_batched_protocols`
entry.

`verify_regression` replays the file BITWISE: rebuild (net, state) from
the registry on `device` (None = CUDA), decode the genome against the
rebuilt live mask, assert the lowered digest matches the pinned one,
re-run the sweep with the pinned seed, and require the exact pinned
objective value.  When a baseline block is pinned, the static 5-plan
sweep is re-scored too and the champion must STRICTLY beat every plan
in it.  `check_regression_doc` is the structural half: schema,
registered protocol, known objective, and genome-in-bounds, without
lowering anything.

`REGRESSIONS_DIR` is the port's own `scenarios/regressions/`, which
holds byte-identical copies of the JAX package's two pins (the p2pflood
and Handel champions its ES campaigns found); the file format is the
same, so a pin written by either package replays in the other.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np

from ..core.registries import registry_batched_protocols
from ..search.driver import baseline_scores
from ..search.genome import FaultGenome, GenomeSpec
from ..search.objectives import OBJECTIVES, score_records
from .sweep import run_fault_sweep

SCHEMA = "witt-regression/v1"
REGRESSIONS_DIR = Path(__file__).resolve().parent / "regressions"

_REQUIRED = (
    "schema",
    "label",
    "protocol",
    "objective",
    "sim_ms",
    "seed0",
    "replicas_per_plan",
    "genome",
    "plan_digest",
    "objective_value",
)


def pin_regression(driver, path: Union[str, Path],
                   with_baseline: bool = True) -> dict:
    """Freeze `driver.champion` at `path` (atomic tmp + os.replace).
    Called through SearchDriver.pin_champion, which also books the
    counter and flight-recorder event."""
    champ = driver.champion
    if champ is None:
        raise RuntimeError("driver has no champion to pin")
    cfg = driver.config
    doc = {
        "schema": SCHEMA,
        "label": cfg.label,
        "protocol": cfg.protocol,
        "objective": cfg.objective,
        "sim_ms": cfg.sim_ms,
        "seed0": int(champ["seed0"]),
        "replicas_per_plan": int(champ["replicas_per_plan"]),
        "genome": {
            "vec": [float(x) for x in champ["vec"]],
            "spec": driver.genome.spec.to_json(),
            "describe": driver.genome.describe(champ["vec"]),
        },
        "plan_digest": champ["plan_digest"],
        "objective_value": float(champ["score"]),
        "availability": float(champ["availability"]),
        "provenance": {
            "optimizer": cfg.optimizer,
            "population": cfg.population,
            "generations_run": driver.generation,
            "found_at_generation": int(champ["generation"]),
            "config_digest": cfg.digest(),
            "config_seed": cfg.seed,
        },
    }
    if with_baseline:
        doc["baseline"] = {
            "seed0": 0,
            "scores": baseline_scores(
                driver.net, driver.state, cfg.sim_ms, cfg.objective, seed0=0
            ),
        }
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    tmp.write_text(json.dumps(doc, indent=2, sort_keys=True) + "\n")
    os.replace(tmp, path)
    return doc


def load_regression(path: Union[str, Path]) -> dict:
    doc = json.loads(Path(path).read_text())
    if doc.get("schema") != SCHEMA:
        raise ValueError(
            f"{path}: schema {doc.get('schema')!r} != {SCHEMA!r}"
        )
    return doc


def list_regressions(directory: Optional[Union[str, Path]] = None) -> List[Path]:
    d = Path(directory) if directory else REGRESSIONS_DIR
    return sorted(d.glob("*.json")) if d.is_dir() else []


def check_regression_doc(doc: dict) -> List[str]:
    """Structural audit; returns problem strings (empty = ok).  The full
    replay (lowering + digest + bitwise score) lives in
    verify_regression."""
    problems: List[str] = []
    for key in _REQUIRED:
        if key not in doc:
            problems.append(f"missing required field {key!r}")
    if problems:
        return problems
    if doc["schema"] != SCHEMA:
        problems.append(f"schema {doc['schema']!r} != {SCHEMA!r}")
    if doc["protocol"] not in registry_batched_protocols.names():
        problems.append(
            f"protocol {doc['protocol']!r} is not a registered batched "
            "protocol"
        )
    if doc["objective"] not in OBJECTIVES:
        problems.append(f"objective {doc['objective']!r} is not registered")
    if not (isinstance(doc["sim_ms"], int) and doc["sim_ms"] >= 2):
        problems.append(f"sim_ms={doc['sim_ms']!r} must be an int >= 2")
    if not (isinstance(doc["replicas_per_plan"], int)
            and doc["replicas_per_plan"] >= 1):
        problems.append(
            f"replicas_per_plan={doc['replicas_per_plan']!r} must be an "
            "int >= 1"
        )
    genome = doc["genome"]
    if not isinstance(genome, dict) or "vec" not in genome or "spec" not in genome:
        problems.append("genome must carry 'vec' and 'spec'")
        return problems
    try:
        spec = GenomeSpec.from_json(genome["spec"])
        spec.validate(np.asarray(genome["vec"], np.float64))
    except (ValueError, KeyError, TypeError) as e:
        problems.append(f"genome does not validate against its spec: {e}")
    base = doc.get("baseline")
    if base is not None:
        scores = base.get("scores")
        if not isinstance(scores, dict) or not scores:
            problems.append("baseline block present but has no scores")
        elif not all(
            float(doc["objective_value"]) > float(s) for s in scores.values()
        ):
            problems.append(
                "pinned objective_value does not strictly beat every "
                "pinned baseline score"
            )
    return problems


def verify_regression(path_or_doc: Union[str, Path, dict],
                      check_baseline: bool = True, device=None) -> dict:
    """Full bitwise replay (module docstring) on `device` (None = CUDA;
    "cpu" runs the plain versions).  Raises AssertionError on any drift;
    returns {'objective_value', 'plan_digest', 'record',
    'baseline_scores'} from the replay."""
    doc = (
        path_or_doc
        if isinstance(path_or_doc, dict)
        else load_regression(path_or_doc)
    )
    problems = check_regression_doc(doc)
    if problems:
        raise AssertionError(
            "regression doc is structurally invalid: " + "; ".join(problems)
        )
    net, state = registry_batched_protocols.get(doc["protocol"]).factory(device=device)
    genome = FaultGenome(
        doc["sim_ms"], net.n_nodes, live=~state.down.cpu().numpy()
    )
    vec = np.asarray(doc["genome"]["vec"], np.float64)
    genome.spec.validate(vec)
    digest = genome.digest(vec, net.protocol.n_msg_types())
    assert digest == doc["plan_digest"], (
        f"lowered-plan digest drifted: replay {digest} != pinned "
        f"{doc['plan_digest']} — the genome no longer lowers to the "
        "attack that was pinned"
    )
    plan = genome.to_plan(vec, label=doc["label"])
    _, records = run_fault_sweep(
        net,
        state,
        [plan],
        doc["sim_ms"],
        replicas_per_plan=doc["replicas_per_plan"],
        seed0=doc["seed0"],
    )
    score = float(
        score_records(records, doc["objective"], doc["sim_ms"])[0]
    )
    assert score == float(doc["objective_value"]), (
        f"replayed objective {score!r} != pinned "
        f"{doc['objective_value']!r} (bitwise replay broken)"
    )
    out = {
        "objective_value": score,
        "plan_digest": digest,
        "record": records[0],
        "baseline_scores": None,
    }
    if check_baseline and doc.get("baseline") is not None:
        base = baseline_scores(
            net, state, doc["sim_ms"], doc["objective"],
            seed0=int(doc["baseline"]["seed0"]),
        )
        out["baseline_scores"] = base
        weaker = {k: v for k, v in base.items() if not score > v}
        assert not weaker, (
            "champion no longer strictly beats the static baselines: "
            + ", ".join(f"{k}={v}" for k, v in weaker.items())
        )
    return out
