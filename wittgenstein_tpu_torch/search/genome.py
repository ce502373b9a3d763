"""Bounded genome over the FaultPlan space.

A genome is a flat float vector, one entry per `GeneSpec`, each bounded
to `[lo, hi]`; integer genes carry real values in the vector and round
at DECODE time, so every optimizer works in one continuous box and the
decoded plan is a pure function of the stored vector (the bitwise-
replay property regression pinning relies on).  `FaultGenome` is the
standard encoding: crash window (which block of live nodes, when, how
long), partition window (minority-group size and timing), per-send drop
rate, latency inflation, and a Byzantine silence mask with its window —
every lane the fault engine exposes.  Lanes whose genes decode to
neutral values (zero crash fraction, drop_pm 0, multiplier 1000 with
add 0 ...) are simply omitted from the built plan, so the genome space
contains the fault-free schedule and every single-lane attack as
corners.

The port's copy of the JAX package's genome: the same genes, bounds,
rounding and node selections, so a vector decodes to the same plan and
`digest` gives the same string in both packages.  `to_plan` builds the
port's `faults.FaultPlan`; the rest is numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..faults.plan import FaultPlan, plan_digest


@dataclasses.dataclass(frozen=True)
class GeneSpec:
    """One bounded gene.  `integer` genes round at decode time."""

    name: str
    lo: float
    hi: float
    integer: bool = False

    def __post_init__(self):
        if not self.lo < self.hi:
            raise ValueError(
                f"gene {self.name!r}: lo={self.lo} must be < hi={self.hi}"
            )

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "lo": self.lo,
            "hi": self.hi,
            "integer": self.integer,
        }

    @classmethod
    def from_json(cls, doc: dict) -> "GeneSpec":
        return cls(
            str(doc["name"]),
            float(doc["lo"]),
            float(doc["hi"]),
            bool(doc.get("integer", False)),
        )


class GenomeSpec:
    """An ordered, named box of genes: the optimizer's search domain."""

    def __init__(self, genes: Sequence[GeneSpec]):
        if not genes:
            raise ValueError("GenomeSpec needs at least one gene")
        names = [g.name for g in genes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate gene names in {names}")
        self.genes: List[GeneSpec] = list(genes)
        self.names: List[str] = names
        self.lo = np.array([g.lo for g in genes], np.float64)
        self.hi = np.array([g.hi for g in genes], np.float64)

    @property
    def n_genes(self) -> int:
        return len(self.genes)

    def clip(self, vec) -> np.ndarray:
        return np.clip(np.asarray(vec, np.float64), self.lo, self.hi)

    def validate(self, vec) -> np.ndarray:
        """The strict twin of clip(): shape/finiteness/bounds or raise.
        Used on vectors that claim to already be genomes (pinned
        regression files), where silent clipping would mask drift."""
        v = np.asarray(vec, np.float64)
        if v.shape != (self.n_genes,):
            raise ValueError(
                f"genome shape {v.shape} != ({self.n_genes},) for genes "
                f"{self.names}"
            )
        if not np.all(np.isfinite(v)):
            raise ValueError(f"genome has non-finite entries: {v.tolist()}")
        bad = (v < self.lo) | (v > self.hi)
        if np.any(bad):
            culprits = [
                f"{self.names[i]}={v[i]} outside [{self.lo[i]},{self.hi[i]}]"
                for i in np.flatnonzero(bad)
            ]
            raise ValueError("genome out of bounds: " + "; ".join(culprits))
        return v

    def decode(self, vec) -> Dict[str, float]:
        """Named view of a validated vector; integer genes round half
        away from zero bias-free (np.rint) and clamp back into bounds."""
        v = self.validate(vec)
        out: Dict[str, float] = {}
        for i, g in enumerate(self.genes):
            x = float(v[i])
            if g.integer:
                x = int(min(max(np.rint(x), g.lo), g.hi))
            out[g.name] = x
        return out

    def random(self, rng: np.random.Generator, n: int = 1) -> np.ndarray:
        """n uniform samples from the box, shape [n, n_genes]."""
        return rng.uniform(self.lo, self.hi, size=(int(n), self.n_genes))

    def center(self) -> np.ndarray:
        return (self.lo + self.hi) / 2.0

    def width(self) -> np.ndarray:
        return self.hi - self.lo

    def to_json(self) -> list:
        return [g.to_json() for g in self.genes]

    @classmethod
    def from_json(cls, doc: list) -> "GenomeSpec":
        return cls([GeneSpec.from_json(g) for g in doc])


class FaultGenome:
    """The standard FaultPlan encoding for an `n_nodes` population over
    a `sim_ms` horizon.  `live` (bool mask or None = all) fixes which
    nodes the crash/silence fractions index into — it must match the
    built state's `~down` for the decoded plan to mean what the search
    saw, which is why regression replays rebuild it from the registry
    factory's state rather than storing node lists."""

    def __init__(self, sim_ms: int, n_nodes: int, live=None):
        sim_ms = int(sim_ms)
        if sim_ms < 2:
            raise ValueError(f"sim_ms={sim_ms} too short for a window")
        self.sim_ms = sim_ms
        self.n_nodes = int(n_nodes)
        self.live = (
            np.ones(self.n_nodes, bool)
            if live is None
            else np.asarray(live, bool).copy()
        )
        if self.live.shape != (self.n_nodes,):
            raise ValueError(
                f"live mask shape {self.live.shape} != ({self.n_nodes},)"
            )
        self._live_ids = np.flatnonzero(self.live)
        t_hi = float(sim_ms - 1)
        self.spec = GenomeSpec(
            [
                # crash lane: a contiguous block of live nodes, placed by
                # crash_off, for [crash_at, crash_at + crash_dur)
                GeneSpec("crash_frac", 0.0, 0.45),
                GeneSpec("crash_off", 0.0, 1.0),
                GeneSpec("crash_at", 0.0, t_hi, integer=True),
                GeneSpec("crash_dur", 1.0, float(sim_ms), integer=True),
                # partition lane: minority group of part_frac * n nodes
                GeneSpec("part_frac", 0.0, 0.5),
                GeneSpec("part_start", 0.0, t_hi, integer=True),
                GeneSpec("part_dur", 1.0, float(sim_ms), integer=True),
                # probabilistic drop lane (all mtypes)
                GeneSpec("drop_pm", 0.0, 1000.0, integer=True),
                GeneSpec("drop_start", 0.0, t_hi, integer=True),
                GeneSpec("drop_dur", 1.0, float(sim_ms), integer=True),
                # latency inflation lane (whole horizon when active)
                GeneSpec("infl_pm", 1000.0, 5000.0, integer=True),
                GeneSpec("infl_add", 0.0, 60.0, integer=True),
                # Byzantine silence lane: a block of live nodes from the
                # TOP of the live list (disjoint from small crash blocks)
                GeneSpec("silence_frac", 0.0, 0.3),
                GeneSpec("byz_start", 0.0, t_hi, integer=True),
                GeneSpec("byz_dur", 1.0, float(sim_ms), integer=True),
            ]
        )

    # -- node-set selections (pure functions of the decoded genome) ----------
    def _crash_nodes(self, g: Dict[str, float]) -> np.ndarray:
        ids = self._live_ids
        k = int(round(g["crash_frac"] * len(ids)))
        if k <= 0:
            return np.empty(0, np.int64)
        start = int(round(g["crash_off"] * (len(ids) - k))) if k < len(ids) else 0
        return ids[start : start + k]

    def _silence_nodes(self, g: Dict[str, float]) -> np.ndarray:
        ids = self._live_ids
        k = int(round(g["silence_frac"] * len(ids)))
        return ids[len(ids) - k :] if k > 0 else np.empty(0, np.int64)

    def to_plan(self, vec, label: str = "genome"):
        """Decode + build the FaultPlan.  Neutral lanes are omitted, so a mid-box genome exercises
        every lane and a corner genome reduces to a single fault."""
        g = self.spec.decode(vec)
        end = lambda start, dur: min(int(start) + int(dur), self.sim_ms)
        plan = FaultPlan(label)
        crash = self._crash_nodes(g)
        if crash.size:
            plan.crash(crash, at=g["crash_at"],
                       recover=end(g["crash_at"], g["crash_dur"]))
        k_part = int(round(g["part_frac"] * self.n_nodes))
        if 0 < k_part < self.n_nodes:
            groups = (np.arange(self.n_nodes) < k_part).astype(np.int32)
            plan.partition(groups, start=g["part_start"],
                           end=end(g["part_start"], g["part_dur"]))
        if g["drop_pm"] > 0:
            plan.drop(g["drop_pm"], start=g["drop_start"],
                      end=end(g["drop_start"], g["drop_dur"]))
        if g["infl_pm"] > 1000 or g["infl_add"] > 0:
            plan.inflate(g["infl_pm"], add_ms=g["infl_add"], start=0)
        silent = self._silence_nodes(g)
        if silent.size:
            plan.silence(silent, start=g["byz_start"],
                         end=end(g["byz_start"], g["byz_dur"]))
        return plan

    def digest(self, vec, n_msg_types: int) -> str:
        """Lowered-plan digest of the decoded genome — the identity a
        pinned regression stores and a replay re-derives."""
        return plan_digest(
            self.to_plan(vec), self.n_nodes, n_msg_types
        )

    def describe(self, vec) -> dict:
        """JSON-friendly decoded view (reports, regression files)."""
        g = self.spec.decode(vec)
        return {
            **g,
            "crash_nodes": int(self._crash_nodes(g).size),
            "silence_nodes": int(self._silence_nodes(g).size),
        }
