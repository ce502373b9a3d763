"""Finding model and rule catalog of the port's contract checks.

Every check in the package reports through `Finding`: a rule id from the
catalog below, a file:line anchor, and a message.  Dynamic findings
anchor at the protocol class's definition line (the scheduler's for
SL801, line 1 of the file for SL301 and SL1401), so the report is
always clickable.  A protocol suppresses a rule for itself by listing
its id in the class's `SIMLINT_SUPPRESS` contract metadata
(engine/protocol.py).

The catalog holds the rules this package checks, with the JAX package's
ids.  The JAX package's source linters (SL1xx, SL2xx, SL1101, SL13xx),
its phase-annotation rule (SL601) and its mesh audit (SL1001) are not
checked here.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from typing import Dict


class Severity(enum.Enum):
    ERROR = "error"
    WARNING = "warning"


# rule id -> one-line description
RULES: Dict[str, str] = {
    # -- registry / test coverage meta-rule ----------------------------------
    "SL301": "batched protocol not registered in core/registries.py or "
    "missing a tests/test_torch_* parity file",
    # -- contract checks on concrete steps -----------------------------------
    "SL401": "kernel hook does not preserve the SimState tree structure, "
    "shapes, or dtypes",
    "SL402": "deliver() output msg store is not a passthrough of its input "
    "(the same tensor, not written in place)",
    "SL403": "telemetry side-car perturbs non-tele state (instrumented run "
    "would not be bit-identical)",
    "SL404": "program drift: step() output leaves drift in shape or dtype "
    "from its input (a new run-cache program every call), or two steps "
    "from one state differ bitwise",
    "SL405": "RNG-stream audit: an on-beat tick_beat advances send_ctr by "
    "other than the declared BEAT_SEND_CALLS",
    "SL406": "fault side-car is not neutral when idle: a fault-enabled "
    "engine on the neutral schedule perturbs non-fault state",
    "SL407": "deliver() writes the fault lane: state.faults leaves must "
    "be pure passthroughs on a fault-enabled delivery view",
    # -- checkpoint durability -----------------------------------------------
    "SL501": "checkpoint completeness: a state leaf is not persisted by "
    "save_state (and not declared in EPHEMERAL_LEAVES), an "
    "EPHEMERAL_LEAVES declaration is stale, or save/load does not "
    "roundtrip bitwise",
    # -- derived-cache consistency --------------------------------------------
    "SL701": "derived-cache consistency: a DERIVED_CACHE_LEAVES leaf is "
    "stale after concrete steps (carried cache differs bitwise from "
    "recompute_caches()), missing from proto_init, or uncovered by the "
    "recompute oracle",
    # -- serving scheduler contract -------------------------------------------
    "SL801": "serve batching contract: jobs packed into one batch must "
    "share the exact static-config digest and row leaf signature, and "
    "re-dispatching an identical workload must be a pure run-cache hit "
    "(no new program per batch)",
    # -- narrow-dtype overflow audit -------------------------------------------
    "SL901": "narrow-dtype overflow audit: an engine message lane or a "
    "declared NARROW_LEAVES leaf (engine.density) cannot hold its bound "
    "— lane plan overridden past (N-1, n_msg_types-1), declared_max "
    "over the dtype's headroom (sentinel slot included), live leaf "
    "dtype diverging from its declaration, or concrete steps producing "
    "values outside [0, declared_max]",
    # -- jump-safety audit --------------------------------------------------------
    "SL1201": "jump-safety audit: a protocol declaring TICK_INTERVAL=None "
    "whose tick_beat is not a passthrough at every probed tick (or that "
    "also declares BEAT_PERIOD) — the next-arrival jump paths skip "
    "empty-occupancy ticks wholesale, so per-tick beat work would "
    "silently vanish",
    # -- pinned regressions ---------------------------------------------------------
    "SL1401": "pinned-regression audit: a scenarios/regressions/*.json "
    "attack pin fails to load, names an unregistered protocol or unknown "
    "objective, carries a genome outside its declared bounds, no longer "
    "strictly beats its pinned baselines, or (contracts mode) lowers to "
    "a FaultState whose digest differs from the pinned plan_digest",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str  # repo-relative when produced by the CLI
    line: int
    message: str
    severity: Severity = Severity.ERROR

    def format(self) -> str:
        return (
            f"{self.path}:{self.line}: {self.rule} "
            f"[{self.severity.value}] {self.message}"
        )

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "severity": self.severity.value,
            "message": self.message,
            "summary": RULES.get(self.rule, ""),
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "Finding":
        """The inverse of to_dict (the summary is the catalog's)."""
        return cls(rule=d["rule"], path=d["path"], line=int(d["line"]),
                   message=d["message"], severity=Severity(d["severity"]))
