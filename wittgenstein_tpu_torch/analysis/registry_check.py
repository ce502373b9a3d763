"""Registry-coverage meta-rule (SL301).

Every batched protocol module of the port must be (a) registered in
`core.registries.registry_batched_protocols`, so the contract passes
enumerate it, and (b) exercised by at least one of the port's test
modules (`tests/test_torch_*.py`).  This is the rule that keeps the
other rules honest: a new `protocols/foo_batched.py` that never
registers would escape the contract checks unseen.

Underscore-prefixed modules (`_agg_batched.py`) are shared bases, not
protocols, and are exempt.
"""

from __future__ import annotations

import glob
import os
from typing import List

from .findings import Finding, Severity

PACKAGE = "wittgenstein_tpu_torch"


def _finding(path: str, msg: str) -> Finding:
    return Finding(rule="SL301", path=path, line=1, message=msg, severity=Severity.ERROR)


def check_registry_coverage(root: str = ".") -> List[Finding]:
    findings: List[Finding] = []
    proto_dir = os.path.join(root, PACKAGE, "protocols")
    if not os.path.isdir(proto_dir):
        return findings
    registry_path = os.path.join(PACKAGE, "core", "registries.py")
    modules = sorted(
        os.path.basename(p)[:-3]
        for p in glob.glob(os.path.join(proto_dir, "*_batched.py"))
        if not os.path.basename(p).startswith("_")
    )
    try:
        from ..core.registries import registry_batched_protocols

        registered = set(registry_batched_protocols.modules())
    except Exception as e:
        return [_finding(registry_path, f"batched-protocol registry failed to import: "
                                        f"{type(e).__name__}: {e}")]

    # one pass over the port's test sources; a mention of the module name
    # (import or factory reference) counts as coverage
    test_sources = []
    for tp in sorted(glob.glob(os.path.join(root, "tests", "test_torch_*.py"))):
        try:
            with open(tp, encoding="utf-8") as fh:
                test_sources.append(fh.read())
        except OSError:
            continue

    for mod in modules:
        relpath = os.path.join(PACKAGE, "protocols", mod + ".py")
        if mod not in registered:
            findings.append(_finding(
                relpath, f"protocols/{mod}.py is not registered in "
                "core.registries.registry_batched_protocols — the contract checks "
                "cannot see it"))
        if not any(mod in src for src in test_sources):
            findings.append(_finding(
                relpath, f"protocols/{mod}.py has no tests/test_torch_*.py referencing it "
                "(parity coverage missing)"))
    # dangling registrations: a registry entry whose module file is gone
    for mod in sorted(registered - set(modules)):
        if not mod.startswith("_"):
            findings.append(_finding(registry_path, f"registry lists module '{mod}' but "
                                                    f"protocols/{mod}.py does not exist"))
    return findings
