"""SL1401: the pinned-regression audit.

`scenarios/regressions/*.json` files are executable claims: each says
"this genome, lowered against THIS registered protocol, scored THIS
value and beat the static baselines", and the tests replay them
bitwise.  A pin that no longer loads, names an unregistered protocol or
unknown objective, or carries a genome outside its own declared bounds
is a regression test that silently stopped testing anything.

Two depths, matching the CLI's fast/contracts split:

  - structural (`lower=False`): JSON loads, schema and required fields,
    protocol registered in core.registries.registry_batched_protocols,
    objective registered in search.objectives.OBJECTIVES, genome within
    its pinned GeneSpec bounds, and a pinned baseline block strictly
    beaten by the pinned objective value;
  - lowering (`lower=True`): additionally rebuild the (net, state) from
    the registry factory on the given device, decode the genome against
    the live mask, lower the plan, and require the lowered FaultState
    digest to equal the pinned `plan_digest` — the "still means the same
    attack" check.  The bitwise score replay stays with
    `scenarios.regressions.verify_regression` (it runs the engine).

The pins are the port's own, under `wittgenstein_tpu_torch/scenarios/
regressions/` of `root`.  Findings anchor at line 1 of the file.
"""

from __future__ import annotations

import json
import os
from typing import List

from ..engine.core import resolve_device
from .findings import Finding, Severity

RULE = "SL1401"


def _finding(path: str, msg: str) -> Finding:
    return Finding(rule=RULE, path=path, line=1, message=msg, severity=Severity.ERROR)


def check_regressions(root: str, lower: bool = False, device=None) -> List[Finding]:
    """Audit every regression pin under `root` (see the module docstring
    for the two depths); the lowering depth builds on `device` (CUDA
    unless asked for the CPU)."""
    from ..scenarios.regressions import check_regression_doc

    dev = resolve_device(device) if lower else None
    reg_dir = os.path.join(root, "wittgenstein_tpu_torch", "scenarios", "regressions")
    findings: List[Finding] = []
    if not os.path.isdir(reg_dir):
        return findings
    for name in sorted(os.listdir(reg_dir)):
        if not name.endswith(".json"):
            continue
        path = os.path.join(reg_dir, name)
        try:
            with open(path, encoding="utf-8") as fh:
                doc = json.load(fh)
        except (OSError, json.JSONDecodeError) as e:
            findings.append(_finding(path, f"does not load as JSON: {e}"))
            continue
        if not isinstance(doc, dict):
            findings.append(_finding(path, "top-level JSON value is not an object"))
            continue
        problems = check_regression_doc(doc)
        findings += [_finding(path, p) for p in problems]
        if lower and not problems:
            findings += _check_lowering(path, doc, dev)
    return findings


def _check_lowering(path: str, doc: dict, device) -> List[Finding]:
    import numpy as np

    from ..core.registries import registry_batched_protocols
    from ..search.genome import FaultGenome

    try:
        net, state = registry_batched_protocols.get(doc["protocol"]).factory(device=device)
    except NotImplementedError:
        # a registered name without a batched factory (ethpow's): the
        # structural checks passed, nothing to lower against
        return []
    try:
        genome = FaultGenome(doc["sim_ms"], net.n_nodes, live=~state.down.cpu().numpy())
        digest = genome.digest(np.asarray(doc["genome"]["vec"], np.float64),
                               net.protocol.n_msg_types())
    except Exception as e:  # any decode or lowering failure is the finding
        return [_finding(path, f"pinned genome fails to lower against the rebuilt "
                               f"{doc['protocol']!r} state: {e}")]
    if digest != doc["plan_digest"]:
        return [_finding(path, f"lowered-plan digest {digest} != pinned {doc['plan_digest']} "
                               "— the pin no longer names the attack it was frozen from")]
    return []
