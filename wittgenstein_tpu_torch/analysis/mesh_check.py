"""2D-mesh replicated-leaf audit (SL1001), the port's counterpart of the
JAX package's analysis/mesh_check.py.

A layout (parallel.mesh2d) places every state leaf by ONE classification
rule: node columns split on the node axis, everything else copied along
it, with the engine-owned message store / telemetry / fault side-cars
excluded BY NAME (node_shard._MESSAGE_STORE_FIELDS) because a wheel
dimension can coincide with n_nodes.  That name-based exclusion is the
audit surface: a protocol field whose path contains an engine store
name would be copied to every node block (correctness survives, the 1/P
memory share dies for that leaf), and a renamed store field leaves its
exclusion stale.

SL1001, per registered protocol at the analysis scale, over the entry's
state with the telemetry side-car armed:

- **classification totality + stacked/single agreement** — every leaf
  classifies the same whether viewed as a single simulation or as a
  stacked replica batch;
- **proto-dict name collisions** — no protocol-owned leaf (under
  ``.proto[``) may match a _MESSAGE_STORE_FIELDS exclusion;
- **stale exclusions** — every _MESSAGE_STORE_FIELDS entry must name at
  least one live leaf across the audited states (checked once over the
  whole registry, anchored at node_shard.py).

Leaf paths are the JAX package's keystr paths (`mesh2d.keyed_leaves`),
so both packages audit the same strings.  Protocol-level suppression:
"SL1001" in the class's SIMLINT_SUPPRESS tuple.
"""

from __future__ import annotations

import os
from typing import List, Optional

from .contracts import _mk, _proto_location, build_entry
from .findings import Finding, Severity

_MAX_LEAF_REPORTS = 4


def check_built_mesh(name: str, net, state, root: str = ".",
                     _stale_seen: Optional[set] = None) -> List[Finding]:
    """SL1001 for one built entry (its engine and single-replica state)."""
    from ..parallel.mesh2d import classify_leaf, keyed_leaves
    from ..parallel.node_shard import _MESSAGE_STORE_FIELDS
    from ..telemetry.state import TelemetryConfig

    path, line = _proto_location(net.protocol)
    try:
        path = os.path.relpath(path, root)
    except ValueError:
        pass
    suppress = set(getattr(net.protocol, "SIMLINT_SUPPRESS", ()) or ())
    if "SL1001" in suppress:
        return []

    findings: List[Finding] = []
    n = net.n_nodes
    flat = list(keyed_leaves(state))
    # plain entries carry empty side-cars (no leaves), so the audit arms
    # telemetry: its counter rows must classify as copied along nodes and
    # their exclusion entries must register as live
    if getattr(net, "telemetry", None) is None:
        try:
            _tnet, tstate = net.with_telemetry(state, TelemetryConfig(snapshots=0))
            flat += list(keyed_leaves(tstate))
        except Exception as e:  # noqa: BLE001 — instrumentation failure
            f = _mk("SL1001", path, line,
                    f"[{name}] telemetry instrumentation failed "
                    f"while arming the side-car mesh audit: "
                    f"{type(e).__name__}: {e}", suppress)
            if f:
                findings.append(f)

    disagree, collide = [], []
    for key, leaf in flat:
        shape = tuple(leaf.shape)
        if _stale_seen is not None:
            for f in _MESSAGE_STORE_FIELDS:
                if f in key:
                    _stale_seen.add(f)
        single = classify_leaf(key, shape, n, stacked=False)
        stacked = classify_leaf(key, (2,) + shape, n, stacked=True)
        # the single-state classes map 1:1 onto the stacked ones
        want = "node-column" if single == "node-column" else "replica-row"
        if stacked != want:
            disagree.append((key, single, stacked))
        if key.startswith(".proto[") and any(f in key for f in _MESSAGE_STORE_FIELDS):
            collide.append(key)

    for key, single, stacked in disagree[:_MAX_LEAF_REPORTS]:
        f = _mk("SL1001", path, line,
                f"[{name}] leaf {key!r} classifies as {single!r} "
                f"single-state but {stacked!r} stacked — the mesh2d "
                "leading-axis offset logic mis-places this shape",
                suppress)
        if f:
            findings.append(f)
    for key in collide[:_MAX_LEAF_REPORTS]:
        f = _mk("SL1001", path, line,
                f"[{name}] protocol-owned leaf {key!r} collides "
                "with an engine _MESSAGE_STORE_FIELDS name — mesh2d "
                "would silently REPLICATE it along the node axis, "
                "forfeiting its 1/P share of the memory budget; rename "
                "the protocol field", suppress)
        if f:
            findings.append(f)
    return findings


def check_entry_mesh(entry, root: str = ".", device=None,
                     _stale_seen: Optional[set] = None) -> List[Finding]:
    """SL1001 for one registry entry built on `device` (CUDA unless the
    CPU is asked for); [] when the entry opts out of contract checks."""
    from ..engine.core import resolve_device

    if not entry.contract_checks:
        return []
    net, state = build_entry(entry, resolve_device(device))
    return check_built_mesh(entry.name, net, state, root, _stale_seen)


def stale_exclusions(seen: set, root: str = ".") -> List[Finding]:
    """One finding for each _MESSAGE_STORE_FIELDS entry no audited leaf
    matched (meaningful only over the whole registry)."""
    from ..parallel import node_shard
    from ..parallel.node_shard import _MESSAGE_STORE_FIELDS

    ns_path = node_shard.__file__
    try:
        ns_path = os.path.relpath(ns_path, root)
    except ValueError:
        pass
    return [
        Finding(
            rule="SL1001", path=ns_path, line=1,
            message=(
                f"_MESSAGE_STORE_FIELDS entry {field!r} matched no "
                "leaf of any registered protocol's state — a stale "
                "exclusion exempts nothing today and silently "
                "exempts a future leaf that reuses the name"
            ),
            severity=Severity.ERROR,
        )
        for field in _MESSAGE_STORE_FIELDS if field not in seen
    ]


def check_mesh_layout(root: str = ".", names=None, device=None) -> List[Finding]:
    """SL1001 over every registered batched protocol (or the named
    subset), plus the registry-wide stale-exclusion sweep."""
    from ..core.registries import registry_batched_protocols

    findings: List[Finding] = []
    seen: set = set()
    audited = False
    for entry in registry_batched_protocols.entries():
        if names and entry.name not in names:
            continue
        if entry.contract_checks:
            audited = True
        findings.extend(check_entry_mesh(entry, root=root, device=device, _stale_seen=seen))
    # stale exclusions only mean something over the FULL sweep
    if audited and not names:
        findings.extend(stale_exclusions(seen, root))
    return findings
