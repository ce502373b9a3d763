"""Beat RNG audit (SL405).

Beat gating preserves the per-event RNG stream only if BEAT_SEND_CALLS
is exact: off-beat ticks advance `send_ctr` by that declared amount
instead of running `tick_beat`, so a protocol whose `tick_beat` moves the
counter by a different amount silently de-synchronizes the stream — the
beat-gated and the ungated paths then simulate different runs, which no
shape check can see.

The JAX package counts `latency_arrivals` calls while tracing tick_beat.
That count is not the counter's advance here: one `latency_arrivals`
call adds 1 to `send_ctr`, but the shared send path (`apply_emissions`)
adds one per drawn emission of a tick at once.  So this audit measures
the advance itself: it runs one on-beat `tick_beat` on the entry's state
(rows live, at a beat tick past 0) and compares how far `send_ctr` moved
in every replica with BEAT_SEND_CALLS.  A declaration without a
BEAT_PERIOD keeps the JAX package's rule: BEAT_SEND_CALLS must be 0.
"""

from __future__ import annotations

from typing import List

import torch

from ..engine.core import resolve_device
from .contracts import _anchor, _batched, _mk, build_entry
from .findings import Finding


def audit_built(name: str, net, state, root: str = ".") -> List[Finding]:
    """SL405 for one built (net, state); [] when clean or beat-free."""
    proto = net.protocol
    path, line = _anchor(proto, root)
    suppress = set(getattr(proto, "SIMLINT_SUPPRESS", ()) or ())

    def mk(msg):
        f = _mk("SL405", path, line, f"[{name}] {msg}", suppress)
        return [f] if f else []

    contract = proto.contract()
    period, residues = contract["beat_period"], contract["beat_residues"]
    declared = contract["beat_send_calls"]
    if period is None:
        if declared:
            return mk(f"BEAT_SEND_CALLS={declared} but BEAT_PERIOD is unset — the "
                      "declaration is dead and will mislead a future beat-gating change")
        return []
    # a beat tick past 0 (residues as the engine reads them, mod period)
    t = int(period) + min((int(r) % int(period) for r in residues or ()), default=0)
    with torch.inference_mode(False), torch.no_grad():
        s = _batched(state)
        try:
            out = proto.tick_beat(net, s, t)
        except Exception as exc:
            return mk(f"tick_beat() failed at the beat tick {t} for the RNG audit: "
                      f"{type(exc).__name__}: {exc}")
        moved = sorted(set((out.send_ctr - s.send_ctr).tolist()))
    if moved != [declared]:
        shown = moved[0] if len(moved) == 1 else moved
        return mk(f"tick_beat() advances send_ctr by {shown} at the beat tick {t} but "
                  f"declares BEAT_SEND_CALLS={declared}; off-beat ticks advance send_ctr "
                  "by the declared amount, so the mismatch de-synchronizes the RNG stream "
                  "between the beat-gated and ungated run paths")
    return []


def audit_entry(entry, root: str = ".", device=None) -> List[Finding]:
    """SL405 for one registry entry on `device` (CUDA unless asked for
    the CPU); [] when clean, exempt, or beat-free."""
    dev = resolve_device(device)
    if not entry.contract_checks:
        return []
    net, state = build_entry(entry, dev)
    return audit_built(entry.name, net, state, root)


def audit_all(root: str = ".", names=None, device=None) -> List[Finding]:
    from ..core.registries import registry_batched_protocols

    dev = resolve_device(device)
    findings: List[Finding] = []
    for entry in registry_batched_protocols.entries():
        if names and entry.name not in names:
            continue
        findings.extend(audit_entry(entry, root=root, device=dev))
    return findings
