"""Checkpoint completeness check (SL501).

Durable runs rest on one claim: a checkpoint holds everything the engine
needs to resume bit-identically.  That claim silently breaks the day a
SimState field is added and `engine.checkpoint.save_state` does not
write it, or a leaf declared ephemeral long ago resumes as its template
value for a reason that no longer holds.

SL501 closes the loop per registered protocol, at the analysis scale
the other dynamic passes use:

- **save coverage** — every leaf of the entry's state lands in the saved
  archive under its path (the keys `save_state` writes, the JAX
  package's), or is declared in `engine.checkpoint.EPHEMERAL_LEAVES`;
- **stale declarations** — every EPHEMERAL_LEAVES entry still names a
  real leaf;
- **bitwise roundtrip** — save -> load reproduces every persisted leaf
  bit for bit (shape, dtype and payload bytes).

Fault-enabled registry entries exercise the fault side-car lane; plain
entries are also checked with telemetry armed (`with_telemetry`,
snapshots=0), so the tele side-car's persistence is covered.
"""

from __future__ import annotations

import os
import tempfile
from typing import List

import numpy as np
import torch

from ..engine.core import resolve_device
from .contracts import _anchor, _mk, build_entry
from .findings import Finding

_MAX_LEAF_REPORTS = 4


def _check_state_checkpoints(name, state, tag, path, line, suppress) -> List[Finding]:
    """Save `state`, assert key coverage and a bitwise roundtrip."""
    from ..engine import checkpoint as ck

    def mk(msg):
        f = _mk("SL501", path, line, f"[{name}] {msg}", suppress)
        return [f] if f else []

    findings: List[Finding] = []
    leaves = ck._host_leaves(state)
    keys = [k for k, _ in leaves]
    with tempfile.TemporaryDirectory(prefix="contracts_sl501_") as td:
        dest = os.path.join(td, "state.ckpt")
        try:
            ck.save_state(state, dest)
        except Exception as e:
            return mk(f"save_state failed on the {tag} state: {type(e).__name__}: {e}")
        with np.load(dest, allow_pickle=False) as data:
            stored = set(data.files)
        missing = [k for k in keys if k not in stored and k not in ck.EPHEMERAL_LEAVES]
        for k in missing[:_MAX_LEAF_REPORTS]:
            findings += mk(f"{tag} state leaf {k!r} is not persisted by save_state and not "
                           "declared in checkpoint.EPHEMERAL_LEAVES — a resumed run would "
                           "silently reset it to the template value")
        if len(missing) > _MAX_LEAF_REPORTS:
            findings += mk(f"... and {len(missing) - _MAX_LEAF_REPORTS} more unpersisted "
                           "leaves")
        for e in [e for e in sorted(ck.EPHEMERAL_LEAVES) if e not in keys][:_MAX_LEAF_REPORTS]:
            findings += mk(f"EPHEMERAL_LEAVES declares {e!r} but the {tag} state has no such "
                           "leaf — remove the stale declaration before it exempts a future "
                           "field")
        if missing:
            return findings  # the roundtrip would only re-report the gap
        try:
            restored = ck.load_state(state, dest)
        except Exception as e:
            return findings + mk(f"load_state failed roundtripping the {tag} state: "
                                 f"{type(e).__name__}: {e}")
    for (p, a), (_, b) in zip(leaves, ck._host_leaves(restored)):
        na, nb = np.asarray(a), np.asarray(b)
        if na.shape != nb.shape or na.dtype != nb.dtype or na.tobytes() != nb.tobytes():
            return findings + mk(f"{tag} state leaf {p} does not roundtrip bitwise through "
                                 "save_state/load_state")
    return findings


def check_built_checkpoint(name: str, net, state, root: str = ".") -> List[Finding]:
    """SL501 for one built (net, state)."""
    path, line = _anchor(net.protocol, root)
    suppress = set(getattr(net.protocol, "SIMLINT_SUPPRESS", ()) or ())
    if "SL501" in suppress:
        return []
    findings = _check_state_checkpoints(name, state, "plain", path, line, suppress)
    # plain entries also get the telemetry side-car armed; fault-lane
    # entries already carry their side-car from the factory
    if getattr(net, "telemetry", None) is None:
        from ..telemetry.state import TelemetryConfig

        try:
            with torch.inference_mode(False), torch.no_grad():
                _tnet, tstate = net.with_telemetry(state, TelemetryConfig(snapshots=0))
        except Exception as e:
            f = _mk("SL501", path, line, f"[{name}] telemetry instrumentation failed while "
                    f"arming the side-car checkpoint check: {type(e).__name__}: {e}",
                    suppress)
            return findings + ([f] if f else [])
        findings += _check_state_checkpoints(name, tstate, "telemetry-armed", path, line,
                                             suppress)
    return findings


def check_entry_checkpoint(entry, root: str = ".", device=None) -> List[Finding]:
    """SL501 for one registry entry on `device` (CUDA unless asked for the
    CPU); [] when clean or when the entry opts out of contract checks
    (standalone engines checkpoint through the same save_state but have
    no generic SimState contract)."""
    dev = resolve_device(device)
    if not entry.contract_checks:
        return []
    net, state = build_entry(entry, dev)
    return check_built_checkpoint(entry.name, net, state, root)


def check_checkpoints(root: str = ".", names=None, device=None) -> List[Finding]:
    """SL501 over every registered batched protocol (or the named subset)."""
    from ..core.registries import registry_batched_protocols

    dev = resolve_device(device)
    findings: List[Finding] = []
    for entry in registry_batched_protocols.entries():
        if names and entry.name not in names:
            continue
        findings.extend(check_entry_checkpoint(entry, root=root, device=dev))
    return findings
