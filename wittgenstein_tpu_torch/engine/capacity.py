"""Telemetry-sized message-store capacities: the contract between the
measured occupancy high-water marks and the constructor knobs.

The table is the JAX package's CAPACITY.json (`witt-capacity/v1`): the
occupancy high-water marks a probe measured for each registered
protocol configuration and the store sizes derived from them.  It holds
counts of the simulation, not speeds, and the port is bit-identical to
the JAX package, so the counts are the port's too; the port keeps a
byte copy at `data/CAPACITY.json`, which `capacity_path()` names by
default.  `state.dropped` stays the runtime guard: a sized run that hits
its ceiling shows a nonzero dropped counter.

Sizing rule: sized = max(floor, ceil(hwm * margin)) rounded up to a
multiple of 8.  Handel's cand_slots uses hwm + 1: the top-K buffer is
re-sorted every tick, so any K' strictly above the post-tick occupancy
high-water mark is bit-identical to the default; one spare slot is the
guard band.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field
from typing import Dict, Optional

CAPACITY_SCHEMA = "witt-capacity/v1"
CAPACITY_BASENAME = "CAPACITY.json"

# seed-to-seed occupancy variance guard for wheel/overflow sizing
DEFAULT_MARGIN = 1.5
# never size below these, however empty the probe ran
MIN_WHEEL_SLOTS = 8
MIN_OVERFLOW = 16

_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")


def capacity_path(root: Optional[str] = None) -> str:
    """`root`'s CAPACITY.json; the port's own copy (data/CAPACITY.json)
    when root is None."""
    return os.path.join(_DATA_DIR if root is None else root, CAPACITY_BASENAME)


def size_from_hwm(
    hwm: int, margin: float = DEFAULT_MARGIN, floor: int = MIN_OVERFLOW
) -> int:
    """hwm -> capacity: margin, floor, then round up to a multiple of 8."""
    sized = max(int(floor), int(math.ceil(int(hwm) * float(margin))))
    return -(-sized // 8) * 8


@dataclass(frozen=True)
class CapacityEntry:
    """One probed (protocol, n_nodes) configuration of the table."""

    protocol: str
    n_nodes: int
    hwms: Dict[str, int]
    sized: Dict[str, int]
    margin: float = DEFAULT_MARGIN
    probe: Dict = field(default_factory=dict)
    dropped: int = 0

    @property
    def key(self) -> str:
        return f"{self.protocol}@{self.n_nodes}"

    def to_json(self) -> dict:
        return {
            "protocol": self.protocol,
            "n_nodes": self.n_nodes,
            "hwms": dict(self.hwms),
            "sized": dict(self.sized),
            "margin": self.margin,
            "probe": dict(self.probe),
            "dropped": self.dropped,
        }


def _entry_problems(key: str, e: dict) -> list:
    """Schema/consistency findings for one table entry (strings)."""
    out = []
    for f in ("protocol", "n_nodes", "hwms", "sized"):
        if f not in e:
            out.append(f"{key}: missing field {f!r}")
    if out:
        return out
    if key != f"{e['protocol']}@{e['n_nodes']}":
        out.append(f"{key}: key does not match protocol@n_nodes fields")
    if int(e.get("dropped", 0)) != 0:
        out.append(
            f"{key}: probe recorded dropped={e['dropped']} — sized run"
            " lost messages; re-probe with larger capacity"
        )
    margin = float(e.get("margin", DEFAULT_MARGIN))
    hwms, sized = e["hwms"], e["sized"]
    # every sized wheel/overflow knob must satisfy the margin rule
    # against its recorded HWM (a hand-edited number fails loudly)
    for knob, hwm_key, floor in (
        ("wheel_slots", "wheel_fill_hwm", MIN_WHEEL_SLOTS),
        ("overflow_capacity", "overflow_hwm", MIN_OVERFLOW),
    ):
        if knob in sized:
            if hwm_key not in hwms:
                out.append(f"{key}: sized {knob} without recorded {hwm_key}")
            elif int(sized[knob]) < size_from_hwm(
                int(hwms[hwm_key]), margin, floor
            ):
                out.append(
                    f"{key}: sized {knob}={sized[knob]} below the margin"
                    f" rule for {hwm_key}={hwms[hwm_key]} (margin {margin})"
                )
    if "cand_slots" in sized:
        if "cand_occ_hwm" not in hwms:
            out.append(f"{key}: sized cand_slots without cand_occ_hwm")
        elif int(sized["cand_slots"]) < int(hwms["cand_occ_hwm"]) + 1:
            out.append(
                f"{key}: cand_slots={sized['cand_slots']} leaves no guard"
                f" slot over cand_occ_hwm={hwms['cand_occ_hwm']}"
                " (bit-identity needs occupancy < K)"
            )
    return out


def validate_table(doc: dict) -> list:
    """All schema problems in a loaded table ([] = valid)."""
    if not isinstance(doc, dict):
        return ["capacity table is not a JSON object"]
    if doc.get("schema") != CAPACITY_SCHEMA:
        return [
            f"schema is {doc.get('schema')!r}, expected {CAPACITY_SCHEMA!r}"
        ]
    entries = doc.get("entries")
    if not isinstance(entries, dict):
        return ["entries missing or not an object"]
    problems = []
    for key, e in entries.items():
        problems.extend(_entry_problems(key, e))
    return problems


def load_capacity(root: Optional[str] = None) -> Optional[dict]:
    """The parsed table, or None when absent, unreadable or invalid:
    callers treat None as "no table" and keep the defaults."""
    path = capacity_path(root)
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if not validate_table(doc) else None


def lookup(
    table: Optional[dict], protocol: str, n_nodes: int
) -> Optional[CapacityEntry]:
    """The CapacityEntry for protocol@n_nodes, or None."""
    if not table:
        return None
    e = table.get("entries", {}).get(f"{protocol}@{int(n_nodes)}")
    if e is None:
        return None
    return CapacityEntry(
        protocol=e["protocol"],
        n_nodes=int(e["n_nodes"]),
        hwms={k: int(v) for k, v in e["hwms"].items()},
        sized={k: int(v) for k, v in e["sized"].items()},
        margin=float(e.get("margin", DEFAULT_MARGIN)),
        probe=dict(e.get("probe", {})),
        dropped=int(e.get("dropped", 0)),
    )


ENGINE_KNOBS = ("wheel_slots", "overflow_capacity")
PROTOCOL_KNOBS = ("cand_slots",)


def sized_overrides(
    entry: Optional[CapacityEntry],
) -> Dict[str, Dict[str, int]]:
    """Split an entry's sized knobs into the two constructor surfaces:
    {"engine": {wheel_slots/overflow_capacity...},
     "protocol": {cand_slots...}}; empty dicts when entry is None."""
    out: Dict[str, Dict[str, int]] = {"engine": {}, "protocol": {}}
    if entry is None:
        return out
    for k, v in entry.sized.items():
        if k in ENGINE_KNOBS:
            out["engine"][k] = int(v)
        elif k in PROTOCOL_KNOBS:
            out["protocol"][k] = int(v)
    return out
