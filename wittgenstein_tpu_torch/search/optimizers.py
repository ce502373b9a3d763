"""Batched black-box optimizers over a GenomeSpec box.

All three share one contract shaped for the engine's free population
evaluator: `ask()` returns the WHOLE generation as an [λ, n_genes]
array, `SearchDriver` (driver.py) evaluates it in ONE
`run_fault_sweep` call, and `tell(pop, scores)` (higher = better)
advances the optimizer.  Row geometry stays fixed (the JAX package's
run cache keys its compiled program on it), so `ask()` always returns
the same number of rows × `replicas_per_plan(base)` replicas — random
search and the ES keep λ fixed, successive halving shrinks the
candidate count and grows replicas by the same power of two.

Everything is host-side numpy and DETERMINISTIC given the seed: the
PCG64 stream is part of `state_meta()`, selection ties break by stable
sort order, and the best-so-far updates on strict improvement only —
so checkpoint/restore (driver.py) reproduces a bitwise-identical
champion, which is what makes kill-and-resume and regression pinning
claims testable.  The port's copy runs the same float64 operations in
the same order as the JAX package's, so both give the same arrays.
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Tuple

import numpy as np

from .genome import GenomeSpec


class SearchOptimizer:
    """Common ask/tell + checkpoint surface (see module docstring)."""

    kind = "base"

    def __init__(self, spec: GenomeSpec, population: int, seed: int = 0):
        if population < 2:
            raise ValueError(f"population={population} must be >= 2")
        self.spec = spec
        self.population = int(population)
        self.seed = int(seed)
        self._rng = np.random.Generator(np.random.PCG64(self.seed))
        self.generation = 0
        self.best_vec: Optional[np.ndarray] = None
        self.best_score = -np.inf

    # -- the ask/tell contract ----------------------------------------------
    def ask(self) -> np.ndarray:
        raise NotImplementedError

    def tell(self, pop: np.ndarray, scores: np.ndarray) -> None:
        """Book the generation: strict-improvement champion update +
        subclass-specific adaptation via _adapt."""
        pop = np.asarray(pop, np.float64)
        scores = np.asarray(scores, np.float64)
        if pop.shape[0] != scores.shape[0]:
            raise ValueError(
                f"{pop.shape[0]} genomes but {scores.shape[0]} scores"
            )
        j = int(np.argmax(scores))  # first index on ties: deterministic
        if scores[j] > self.best_score:
            self.best_score = float(scores[j])
            self.best_vec = pop[j].copy()
        self._adapt(pop, scores)
        self.generation += 1

    def _adapt(self, pop: np.ndarray, scores: np.ndarray) -> None:
        pass

    def replicas_per_plan(self, base: int) -> int:
        """Replica rows per candidate this generation (SHA grows it as
        the candidate count halves, keeping row geometry constant)."""
        return int(base)

    # -- checkpoint surface (driver.py persists these) -----------------------
    def state_arrays(self) -> Dict[str, np.ndarray]:
        """Fixed-structure numpy pytree (CheckpointManager template)."""
        n = self.spec.n_genes
        return {
            "best_vec": (
                np.zeros(n) if self.best_vec is None else self.best_vec.copy()
            ),
        }

    def state_meta(self) -> dict:
        """JSON side-car: everything state_arrays can't hold."""
        return {
            "kind": self.kind,
            "generation": self.generation,
            "best_score": (
                None if self.best_vec is None else self.best_score
            ),
            "rng": json.loads(json.dumps(self._rng.bit_generator.state)),
        }

    def load_state(self, arrays: Dict[str, np.ndarray], meta: dict) -> None:
        if meta["kind"] != self.kind:
            raise ValueError(
                f"checkpoint is a {meta['kind']!r} optimizer, this is "
                f"{self.kind!r}"
            )
        self.generation = int(meta["generation"])
        if meta["best_score"] is None:
            self.best_vec, self.best_score = None, -np.inf
        else:
            self.best_score = float(meta["best_score"])
            self.best_vec = np.asarray(arrays["best_vec"], np.float64).copy()
        self._rng.bit_generator.state = meta["rng"]


class RandomSearch(SearchOptimizer):
    """Seeded uniform sampling of the box — the coverage baseline every
    structured optimizer must beat, and the diversity engine for short
    CI searches (a fresh λ-sample per generation never collapses)."""

    kind = "random"

    def ask(self) -> np.ndarray:
        return self.spec.random(self._rng, self.population)


class EvolutionStrategy(SearchOptimizer):
    """(μ,λ) evolution strategy with diagonal covariance (CMA-lite):
    log-weighted recombination of the top μ, per-dimension step sizes
    re-estimated from the selected parents' spread and blended with the
    carried sigma (no evolution paths — the genome is ~15-dimensional
    and the budget is a handful of generations)."""

    kind = "es"

    def __init__(self, spec: GenomeSpec, population: int, seed: int = 0,
                 mu: Optional[int] = None, sigma0_frac: float = 0.25,
                 sigma_blend: float = 0.3):
        super().__init__(spec, population, seed)
        self.mu = int(mu) if mu is not None else max(2, self.population // 2)
        if not 2 <= self.mu <= self.population:
            raise ValueError(
                f"mu={self.mu} outside [2, population={self.population}]"
            )
        w = np.log(self.mu + 0.5) - np.log(np.arange(1, self.mu + 1))
        self._weights = w / w.sum()
        self._sigma_blend = float(sigma_blend)
        self._sigma_floor = spec.width() * 1e-3
        self.mean = spec.center()
        self.sigma = spec.width() * float(sigma0_frac)

    def ask(self) -> np.ndarray:
        z = self._rng.standard_normal((self.population, self.spec.n_genes))
        return self.spec.clip(self.mean + z * self.sigma)

    def _adapt(self, pop: np.ndarray, scores: np.ndarray) -> None:
        order = np.argsort(-scores, kind="stable")[: self.mu]
        parents = pop[order]
        old_mean = self.mean
        self.mean = self._weights @ parents
        spread = np.sqrt(
            self._weights @ (parents - old_mean) ** 2
        )
        self.sigma = np.maximum(
            (1.0 - self._sigma_blend) * self.sigma
            + self._sigma_blend * spread,
            self._sigma_floor,
        )

    def state_arrays(self) -> Dict[str, np.ndarray]:
        return {
            **super().state_arrays(),
            "mean": self.mean.copy(),
            "sigma": self.sigma.copy(),
        }

    def load_state(self, arrays, meta) -> None:
        super().load_state(arrays, meta)
        self.mean = np.asarray(arrays["mean"], np.float64).copy()
        self.sigma = np.asarray(arrays["sigma"], np.float64).copy()


class SuccessiveHalving(SearchOptimizer):
    """Successive-halving bandit: rung 0 screens λ fresh candidates at
    `base` replicas each; each rung keeps the top half and doubles the
    replicas per survivor, so every rung is the SAME row count (and the
    same compiled program).  After `rungs` rungs the ladder restarts
    with a fresh sample.  `population` must be a power of two ≥ 4."""

    kind = "sha"

    def __init__(self, spec: GenomeSpec, population: int, seed: int = 0,
                 rungs: Optional[int] = None):
        super().__init__(spec, population, seed)
        if self.population < 4 or self.population & (self.population - 1):
            raise ValueError(
                f"population={self.population} must be a power of two >= 4"
            )
        max_rungs = int(np.log2(self.population)) + 1
        self.rungs = min(int(rungs), max_rungs) if rungs else max_rungs - 1
        if self.rungs < 2:
            raise ValueError(f"rungs={self.rungs} must be >= 2")
        self.rung = 0
        self._candidates = self.spec.random(self._rng, self.population)

    def _n_this_rung(self) -> int:
        return self.population >> self.rung

    def replicas_per_plan(self, base: int) -> int:
        return int(base) << self.rung

    def ask(self) -> np.ndarray:
        return self._candidates.copy()

    def _adapt(self, pop: np.ndarray, scores: np.ndarray) -> None:
        keep = max(2, pop.shape[0] // 2)
        order = np.argsort(-scores, kind="stable")[:keep]
        self.rung += 1
        if self.rung >= self.rungs:
            # ladder exhausted: restart with a fresh screening sample
            self.rung = 0
            self._candidates = self.spec.random(self._rng, self.population)
        else:
            self._candidates = pop[np.sort(order)].copy()

    def state_arrays(self) -> Dict[str, np.ndarray]:
        # fixed geometry: pad the surviving candidates back to [λ, n]
        cand = np.zeros((self.population, self.spec.n_genes))
        cand[: len(self._candidates)] = self._candidates
        return {**super().state_arrays(), "candidates": cand}

    def state_meta(self) -> dict:
        return {
            **super().state_meta(),
            "rung": self.rung,
            "n_candidates": len(self._candidates),
        }

    def load_state(self, arrays, meta) -> None:
        super().load_state(arrays, meta)
        self.rung = int(meta["rung"])
        self._candidates = np.asarray(
            arrays["candidates"], np.float64
        )[: int(meta["n_candidates"])].copy()


_KINDS = {
    "random": RandomSearch,
    "es": EvolutionStrategy,
    "sha": SuccessiveHalving,
}


def make_optimizer(kind: str, spec: GenomeSpec, population: int,
                   seed: int = 0, **kw) -> SearchOptimizer:
    try:
        cls = _KINDS[kind]
    except KeyError:
        raise KeyError(
            f"unknown optimizer {kind!r} (known: "
            + ", ".join(sorted(_KINDS)) + ")"
        ) from None
    return cls(spec, population, seed=seed, **kw)
