"""Command line of the contract checks: `python -m wittgenstein_tpu_torch.analysis`.

Runs seven passes and prints findings as `path:line: RULE [sev] msg` (or
JSONL with --format json):

  1. contract checks on concrete steps       (SL401-SL404, SL406, SL407,
                                              SL701, SL901, SL1201)
  2. beat RNG audit                          (SL405)
  3. checkpoint completeness                 (SL501)
  4. 2D-mesh replicated-leaf audit           (SL1001)
  5. serve scheduler batching contract       (SL801)
  6. pinned-regression audit                 (SL1401)
  7. registry/test coverage meta-rule        (SL301)

Passes 1-5 and the lowering depth of 6 build every registered protocol
on `--device` (CUDA unless `cpu`) and run its hooks; each entry is built
once and shared by the passes.  `--skip-contracts` runs only the passes
that build nothing: 7, and 6 at its structural depth.

Exit status: 0 when clean; 1 when any ERROR finding (or, with --strict,
any finding at all) survives; 2 on usage errors.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import List, Optional

from .findings import Finding, Severity

PASSES = ("contracts", "rng", "checkpoint", "mesh", "serve", "regressions", "registry")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m wittgenstein_tpu_torch.analysis",
        description="contract checks of the port's batched protocols",
    )
    p.add_argument("--root", default=".",
                   help="repo root containing wittgenstein_tpu_torch/ (default .)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a GPU) or cpu")
    p.add_argument("--strict", action="store_true",
                   help="exit nonzero on ANY finding, warnings included")
    p.add_argument("--format", choices=("text", "json"), default="text",
                   help="findings as text lines or JSONL")
    p.add_argument("-o", "--output", default=None,
                   help="also write findings (JSONL) to this file")
    p.add_argument("--skip-contracts", action="store_true",
                   help="skip every pass that builds a protocol (registry rule and "
                   "structural regression audit only)")
    p.add_argument("--protocol", action="append", default=None, metavar="NAME",
                   help="restrict the building passes to this registered protocol "
                   "(repeatable)")
    return p


def _rel(path: str, root: str) -> str:
    try:
        rel = os.path.relpath(path, root)
    except ValueError:
        return path
    return path if rel.startswith("..") else rel


def run(root: str = ".", device=None, skip_contracts: bool = False,
        protocols: Optional[List[str]] = None, stats: Optional[dict] = None) -> List[Finding]:
    """Every pass over `root` on `device` (CUDA unless asked for the CPU);
    returns the findings.  `stats`, when given, receives each pass's
    {"entries", "seconds"}."""
    from ..core.registries import registry_batched_protocols
    from ..engine.core import resolve_device
    from .checkpoint_check import check_built_checkpoint
    from .contracts import build_entry, run_checks
    from .mesh_check import check_built_mesh, stale_exclusions
    from .regressions_check import check_regressions
    from .registry_check import check_registry_coverage
    from .rng_audit import audit_built
    from .serve_check import check_serve_scheduler

    dev = resolve_device(device)
    stats = {} if stats is None else stats
    if protocols:
        unknown = set(protocols) - set(registry_batched_protocols.names())
        if unknown:
            raise SystemExit("contract checks: unknown protocol(s): " + ", ".join(sorted(unknown))
                             + " (known: " + ", ".join(registry_batched_protocols.names()) + ")")
    findings: List[Finding] = []

    def timed(name: str, entries: int, fn) -> None:
        t0 = time.perf_counter()
        findings.extend(fn())
        stats[name] = {"entries": entries, "seconds": time.perf_counter() - t0}

    if not skip_contracts:
        entries = [e for e in registry_batched_protocols.entries()
                   if e.contract_checks and (not protocols or e.name in protocols)]
        built = {}

        def per_entry(check):
            out = []
            for e in entries:
                if e.name not in built:
                    built[e.name] = build_entry(e, dev)
                out += check(e.name, *built[e.name], root)
            return out

        timed("contracts", len(entries), lambda: per_entry(run_checks))
        timed("rng", len(entries), lambda: per_entry(audit_built))
        timed("checkpoint", len(entries), lambda: per_entry(check_built_checkpoint))
        seen: set = set()

        def mesh():
            out = per_entry(lambda name, net, state, root:
                            check_built_mesh(name, net, state, root, seen))
            # stale exclusions mean something only over the whole registry
            return out + (stale_exclusions(seen, root) if entries and not protocols else [])

        timed("mesh", len(entries), mesh)
        built.clear()
        timed("serve", 1, lambda: check_serve_scheduler(root, names=protocols, device=dev))
    pins = os.path.join(root, "wittgenstein_tpu_torch", "scenarios", "regressions")
    n_pins = len([n for n in os.listdir(pins) if n.endswith(".json")]) if os.path.isdir(pins) else 0
    timed("regressions", n_pins,
          lambda: check_regressions(root, lower=not skip_contracts, device=dev))
    timed("registry", len(registry_batched_protocols.modules()),
          lambda: check_registry_coverage(root))
    return [dataclasses.replace(f, path=_rel(f.path, root)) for f in findings]


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    root = os.path.abspath(args.root)
    if not os.path.isdir(os.path.join(root, "wittgenstein_tpu_torch")):
        print(f"contract checks: no wittgenstein_tpu_torch/ package under {root}",
              file=sys.stderr)
        return 2
    findings = run(root, device=args.device, skip_contracts=args.skip_contracts,
                   protocols=args.protocol)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    for f in findings:
        print(f.to_json() if args.format == "json" else f.format())
    if args.output:
        with open(args.output, "w", encoding="utf-8") as fh:
            for f in findings:
                fh.write(f.to_json() + "\n")
    n_err = sum(1 for f in findings if f.severity is Severity.ERROR)
    n_warn = len(findings) - n_err
    print(f"contract checks: {n_err} error(s), {n_warn} warning(s)" if findings
          else "contract checks: clean", file=sys.stderr)
    if n_err or (args.strict and findings):
        return 1
    return 0
