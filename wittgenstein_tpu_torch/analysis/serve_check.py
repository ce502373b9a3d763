"""SL801: the serving scheduler's batching contract.

The serve layer's throughput rests on one invariant: every job packed
into a batch shares the exact static-config digest (protocol + params +
horizon + chunk schedule + template leaf signature), so a steady
workload is served from a fixed number of programs.  A per-job knob
leaking into a batch — a params field that should split the
compatibility key but does not, or a rebuilt engine defeating the run
cache's id()-keyed entries — turns "one program per family" into "one
program per job" without any test failing on correctness.  This pass
pins the contract dynamically, on the scheduler's device:

  1. **digest purity** — plan a mixed pending set (seed sweep, fault
     plan, a params variant); every planned batch's jobs resolve to ONE
     family digest, and the variant lands in a different batch with a
     different digest;
  2. **row uniformity** — the packed rows of a planned batch share one
     leaf signature (shapes and dtypes);
  3. **program amortization** — dispatching a second identical workload
     is a pure run-cache hit: no new miss and no new program
     (`compiles`, the first call of an entry at a new input geometry).
"""

from __future__ import annotations

import inspect
import os
from typing import List, Optional

from ..engine.core import resolve_device
from .findings import Finding, Severity


def _anchor(root: str):
    """(repo-relative path, line) of the BatchScheduler definition —
    every SL801 finding points at the scheduler."""
    from ..serve.scheduler import BatchScheduler

    path = inspect.getsourcefile(BatchScheduler) or "wittgenstein_tpu_torch/serve/scheduler.py"
    try:
        line = inspect.getsourcelines(BatchScheduler)[1]
    except OSError:
        line = 1
    try:
        rel = os.path.relpath(path, root)
        if not rel.startswith(".."):
            path = rel
    except ValueError:
        pass
    return path, line


def _finding(path: str, line: int, msg: str) -> Finding:
    return Finding("SL801", path, line, msg, Severity.ERROR)


SERVE_SPECS = (
    {"protocol": "PingPong", "params": {"node_ct": 32}, "simMs": 60, "seed": 0},
    {"protocol": "PingPong", "params": {"node_ct": 32}, "simMs": 60, "seed": 1},
    {"protocol": "PingPong", "params": {"node_ct": 32}, "simMs": 60, "seed": 1,
     "faults": [{"op": "crash", "nodes": [1], "at": 10}]},
    # a params change: MUST split the batch
    {"protocol": "PingPong", "params": {"node_ct": 48}, "simMs": 60, "seed": 0},
)


def check_serve_scheduler(root: str = ".", names: Optional[List[str]] = None,
                          device=None, scheduler_cls=None) -> List[Finding]:
    """SL801 over a mixed PingPong workload on `device` (CUDA unless asked
    for the CPU).  `scheduler_cls` replaces BatchScheduler (a seeded
    defect's subclass)."""
    dev = resolve_device(device)
    if names and "PingPong" not in names:
        return []
    from ..parallel.replica_shard import run_cache_info
    from ..serve.jobs import JobState
    from ..serve.scheduler import BatchScheduler, _leaf_signature

    path, line = _anchor(root)
    findings: List[Finding] = []
    sched = (scheduler_cls or BatchScheduler)(auto_start=False, max_batch_replicas=4,
                                              device=dev)
    jobs = [sched.submit(dict(s)) for s in SERVE_SPECS]
    by_id = {j.id: j for j in jobs}
    split_job = jobs[-1]

    for plan in sched.plan_batches():
        # 1. digest purity and 2. row uniformity within every batch
        digests, sigs = set(), set()
        for jid in plan["jobs"]:
            job = by_id[jid]
            fam = sched.family_for(job.spec)
            digests.add(fam.digest)
            sigs.add(_leaf_signature(sched._row(fam, job.spec)))
        if len(digests) > 1:
            findings.append(_finding(
                path, line, f"batch {plan['jobs']} mixes static-config digests "
                f"{sorted(digests)} — jobs packed together must share one program"))
        if len(sigs) > 1:
            findings.append(_finding(
                path, line, f"batch {plan['jobs']} packs rows with differing leaf "
                "signatures — the stacked state would not match the family's program"))
        if split_job.id in plan["jobs"] and len(plan["jobs"]) > 1:
            findings.append(_finding(
                path, line, "a params variant (node_ct=48) was planned into the same "
                "batch as node_ct=32 jobs — the compatibility key ignores a "
                "state-shaping param"))
    if sched.family_for(jobs[0].spec).digest == sched.family_for(split_job.spec).digest:
        findings.append(_finding(
            path, line, "node_ct=32 and node_ct=48 resolved to the same family digest — "
            "params are not part of the compatibility key"))
    if findings:
        return findings

    # 3. program amortization: run everything, then an identical second
    # wave, which must be pure cache hits
    while sched.drain_once():
        pass
    for j in jobs:
        if j.state is not JobState.DONE:
            return [_finding(path, line, f"fixture job {j.id} finished {j.state.value} "
                             f"({j.error}) — the contract run itself failed")]
    before = run_cache_info()
    wave2 = [sched.submit(dict(s)) for s in SERVE_SPECS]
    while sched.drain_once():
        pass
    after = run_cache_info()
    for j in wave2:
        if j.state is not JobState.DONE:
            return [_finding(path, line, f"second-wave job {j.id} finished "
                             f"{j.state.value} ({j.error})")]
    new_misses = after["misses"] - before["misses"]
    new_compiles = after["compiles"] - before["compiles"]
    if new_misses or new_compiles:
        findings.append(_finding(
            path, line, f"re-dispatching an identical workload cost {new_misses} run-cache "
            f"miss(es) / {new_compiles} new program(s) — the scheduler builds a program "
            "per batch instead of serving steady workloads from cached ones"))
    return findings
