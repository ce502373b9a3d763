"""Resumable search driver: optimizer generations over run_fault_sweep.

One generation = ONE `run_fault_sweep` call: the optimizer's whole
population lowers to FaultState rows of a single `run_ms_batched` run at
a fixed horizon (`stop_when_done=False`, the program the JAX package's
cached path runs), so a generation is one batched run on the device.

Durability rides the engine's checkpoint discipline: after every
`tell`, the optimizer state (arrays in CheckpointManager's atomic
numbered files, scalars/RNG/history in its meta side-car) lands under
`config.checkpoint_dir`; a killed search re-invoked with the same
config resumes at the next generation and reaches a bitwise-identical
champion, because every seed is a pure function of (config.seed,
generation) and the optimizer stream is part of the checkpoint.  The
file is the JAX package's, so a campaign can resume in either package.

Per-generation flight-recorder events (`search-generation`, plus
resume/complete/pinned) and monotonic `SEARCH_COUNTERS` make a campaign
observable.

Champions pin through `scenarios.regressions` as witt-regression/v1
JSON — genome, lowered-plan digest, seed, objective value, and the
static-baseline scores they strictly beat — replayed bitwise by
`scenarios.regressions.verify_regression`.

`SearchConfig` has the JAX package's fields and nothing more: its
`digest()` hashes them all, and the pinned champions name that digest.
The device is an argument of `SearchDriver` instead (None = CUDA; it
raises without a card, as every entry point of the port does).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from typing import List, Optional

import numpy as np

from ..core.registries import registry_batched_protocols
from ..engine.checkpoint import CheckpointManager
from ..faults import FaultPlan
from ..obs.recorder import get_recorder
from ..scenarios.sweep import run_fault_sweep
from .genome import FaultGenome, GeneSpec, GenomeSpec
from .objectives import get_objective, pareto_frontier, score_records
from .optimizers import make_optimizer

# monotonic per-process counters (the JAX package's server renders them
# as witt_search_* metric families)
SEARCH_COUNTERS = {
    "generations_total": 0,
    "evals_total": 0,
    "eval_seconds_total": 0.0,
    "pinned_total": 0,
    "best_objective": 0.0,  # gauge: last champion objective seen
}


def search_metrics() -> dict:
    return dict(SEARCH_COUNTERS)


@dataclasses.dataclass
class SearchConfig:
    """One search campaign.  `protocol` must be a
    core.registries.registry_batched_protocols name — the registry
    factory is how a regression replay rebuilds the exact (net, state)
    the campaign attacked."""

    protocol: str
    objective: str = "done_at"
    sim_ms: int = 1000
    generations: int = 3
    population: int = 8
    replicas_per_plan: int = 1
    seed: int = 0
    optimizer: str = "es"
    checkpoint_dir: Optional[str] = None
    label: str = "search"

    def digest(self) -> str:
        """Identity of the campaign (resume guard): a checkpoint from a
        different config must not silently seed this one."""
        doc = dataclasses.asdict(self)
        doc.pop("checkpoint_dir")  # the directory is where, not what
        return hashlib.blake2b(
            json.dumps(doc, sort_keys=True).encode(), digest_size=8
        ).hexdigest()


def static_baseline_plans(net, state) -> list:
    """The static 5-plan sweep (control + four single-lane faults) every
    discovered champion must strictly beat — one definition shared by
    tools/fault_sweep.py and the regression verifier."""
    n = net.n_nodes
    live = np.flatnonzero(~state.down.cpu().numpy())
    crash_ids = live[len(live) // 4 :][: max(1, len(live) // 5)]  # 20% of live
    groups = np.arange(n) % 2
    return [
        None,  # fault-free control row
        FaultPlan("crash20@200").crash(crash_ids, at=200),
        FaultPlan("split@100-600").partition(groups, start=100, end=600),
        FaultPlan("drop30%").drop(300, start=0),
        FaultPlan("slow3x").inflate(3000, add_ms=20, start=0),
    ]


class SearchDriver:
    """ask -> one batched sweep -> tell, resumably (module docstring)."""

    def __init__(self, config: SearchConfig, net=None, state=None,
                 recorder=None, device=None):
        self.config = config
        if net is None or state is None:
            net, state = registry_batched_protocols.get(
                config.protocol
            ).factory(device=device)
        self.net, self.state = net, state
        self.genome = FaultGenome(
            config.sim_ms, net.n_nodes, live=~state.down.cpu().numpy()
        )
        self.objective = get_objective(config.objective)
        self.opt = make_optimizer(
            config.optimizer, self.genome.spec, config.population,
            seed=config.seed,
        )
        if recorder is None:
            recorder = get_recorder()
        self.recorder = recorder
        self.history: List[dict] = []  # one row per completed generation
        self.points: List[dict] = []   # every evaluated candidate
        self.champion: Optional[dict] = None
        self._ckpt = None
        if config.checkpoint_dir:
            self._ckpt = CheckpointManager(config.checkpoint_dir)
            self._maybe_resume()

    # -- durability ----------------------------------------------------------
    @property
    def generation(self) -> int:
        return self.opt.generation

    @staticmethod
    def _pack(arrays: dict) -> dict:
        """float64 optimizer arrays as raw-byte uint8 views: the JAX
        package's checkpoint restore round-trips leaves through jax
        (float32 under its default no-x64 config), and a champion genome
        that loses low bits can decode to a DIFFERENT plan — so both
        packages ship bytes, and an optimizer checkpoint is the same file
        in either."""
        return {
            k: np.ascontiguousarray(v, np.float64).view(np.uint8)
            for k, v in arrays.items()
        }

    @staticmethod
    def _unpack(arrays: dict) -> dict:
        return {
            k: np.ascontiguousarray(np.asarray(v, np.uint8)).view(np.float64)
            for k, v in arrays.items()
        }

    def _checkpoint(self) -> None:
        if self._ckpt is None:
            return
        meta = {
            "config_digest": self.config.digest(),
            "opt": self.opt.state_meta(),
            "history": self.history,
            "points": self.points,
            "champion": self.champion,
        }
        self._ckpt.save(
            self._pack(self.opt.state_arrays()), self.generation, meta=meta
        )
        self.recorder.record(
            "checkpoint", search=self.config.label, gen=self.generation
        )

    def _maybe_resume(self) -> None:
        got = self._ckpt.restore_latest(self._pack(self.opt.state_arrays()))
        if got is None:
            return
        arrays, step, manifest = got
        meta = (manifest or {}).get("meta") or {}
        if meta.get("config_digest") != self.config.digest():
            raise ValueError(
                f"checkpoint in {self.config.checkpoint_dir} belongs to a "
                "different search config — refusing to resume from it"
            )
        self.opt.load_state(self._unpack(arrays), meta["opt"])
        self.history = list(meta["history"])
        self.points = list(meta["points"])
        self.champion = meta["champion"]
        self.recorder.record(
            "search-resume", search=self.config.label, gen=self.generation
        )

    # -- one generation = one batched sweep ----------------------------------
    def _gen_seed0(self, gen: int) -> int:
        # disjoint seed blocks per generation, pure in (config, gen)
        rows = self.config.population * self.config.replicas_per_plan
        return self.config.seed + 1 + gen * rows

    def run_generation(self) -> dict:
        cfg = self.config
        gen = self.generation
        pop = self.opt.ask()
        rpp = self.opt.replicas_per_plan(cfg.replicas_per_plan)
        plans = [
            self.genome.to_plan(vec, label=f"{cfg.label}-g{gen}c{j}")
            for j, vec in enumerate(pop)
        ]
        seed0 = self._gen_seed0(gen)
        t0 = time.perf_counter()
        _, records = run_fault_sweep(
            self.net, self.state, plans, cfg.sim_ms,
            replicas_per_plan=rpp, seed0=seed0, stop_when_done=False,
        )
        eval_s = time.perf_counter() - t0
        scores = score_records(records, cfg.objective, cfg.sim_ms)
        self.opt.tell(pop, scores)

        j_best = int(np.argmax(scores))
        if self.champion is None or scores[j_best] > self.champion["score"]:
            rec = records[j_best]
            self.champion = {
                "score": float(scores[j_best]),
                "vec": [float(x) for x in pop[j_best]],
                "plan_digest": rec["plan_digest"],
                "seed0": rec["seed0_row"],
                "replicas_per_plan": rpp,
                "availability": rec["availability"],
                "generation": gen,
                "record": rec,
            }
            SEARCH_COUNTERS["best_objective"] = self.champion["score"]
        for j, rec in enumerate(records):
            self.points.append(
                {
                    "gen": gen,
                    "unavailability": round(1.0 - rec["availability"], 4),
                    "done_p90": (
                        rec["done_at_ms"]["p90"]
                        if rec["done_at_ms"]
                        else cfg.sim_ms
                    ),
                    "score": float(scores[j]),
                    "plan_digest": rec["plan_digest"],
                }
            )
        row = {
            "gen": gen,
            "evals": len(plans),
            "replicas_per_plan": rpp,
            "eval_s": round(eval_s, 4),
            "best_gen_score": float(scores[j_best]),
            "champion_score": self.champion["score"],
        }
        self.history.append(row)
        SEARCH_COUNTERS["generations_total"] += 1
        SEARCH_COUNTERS["evals_total"] += len(plans) * rpp
        SEARCH_COUNTERS["eval_seconds_total"] += eval_s
        self.recorder.record(
            "search-generation", search=cfg.label, **row
        )
        self._checkpoint()
        return row

    def run(self) -> dict:
        while self.generation < self.config.generations:
            self.run_generation()
        report = self.report()
        self.recorder.record(
            "search-complete",
            search=self.config.label,
            generations=self.generation,
            champion_score=self.champion["score"] if self.champion else None,
        )
        return report

    # -- outputs -------------------------------------------------------------
    def frontier(self) -> List[dict]:
        """Availability-vs-latency Pareto frontier over every evaluated
        candidate (attacker view: maximize unavailability AND done-at
        p90), deduped by plan digest."""
        if not self.points:
            return []
        seen, pts = set(), []
        for p in self.points:
            if p["plan_digest"] not in seen:
                seen.add(p["plan_digest"])
                pts.append(p)
        keep = pareto_frontier(
            [(p["unavailability"], p["done_p90"]) for p in pts]
        )
        front = [pts[i] for i in keep]
        front.sort(key=lambda p: (-p["unavailability"], -p["done_p90"]))
        return front

    def report(self) -> dict:
        return {
            "schema": "witt-search-report/v1",
            "config": dataclasses.asdict(self.config),
            "config_digest": self.config.digest(),
            "champion": self.champion,
            "frontier": self.frontier(),
            "history": self.history,
            "metrics": search_metrics(),
        }

    def pin_champion(self, path: str, with_baseline: bool = True) -> dict:
        """Pin the champion as a replayable witt-regression/v1 file (see
        scenarios.regressions); returns the written document."""
        # scenarios.regressions imports this module
        from ..scenarios.regressions import pin_regression

        if self.champion is None:
            raise RuntimeError("no champion yet — run at least one generation")
        doc = pin_regression(self, path, with_baseline=with_baseline)
        SEARCH_COUNTERS["pinned_total"] += 1
        self.recorder.record(
            "search-pinned", search=self.config.label, path=path,
            plan_digest=doc["plan_digest"],
        )
        return doc


def baseline_scores(net, state, sim_ms: int, objective: str,
                    seed0: int = 0) -> dict:
    """Objective score of every static baseline plan (label -> score),
    evaluated at replicas_per_plan=1 — the bar a champion must clear."""
    plans = static_baseline_plans(net, state)
    _, records = run_fault_sweep(net, state, plans, sim_ms, seed0=seed0)
    scores = score_records(records, objective, sim_ms)
    return {
        rec["plan"]["label"]: float(s) for rec, s in zip(records, scores)
    }


def optimize_env_policy(env, generations: int = 3, seed: int = 0,
                        optimizer: str = "es", objective: str = "reward_ratio",
                        recorder=None):
    """Drive the SAME optimizers against an in-protocol adversary
    policy: each replica of a vectorized attack env (protocols/
    handel_env.BatchedAttackEnv, or the ethpow BatchedMinerEnv wrapped
    the same way) rolls out ONE candidate's attack window, so a whole
    generation is a single batched rollout.  The policy genome is the
    (start, duration) of the Byzantine window; actions at each decision
    step are 1 inside the candidate's window.  Returns the optimizer
    (best_vec/best_score are the discovered policy).  `optimizer` must
    keep the population fixed ('random'/'es' — SHA varies candidate
    count, which an R-replica env cannot fan out)."""
    if optimizer == "sha":
        raise ValueError(
            "optimize_env_policy needs a fixed population per rollout; "
            "sha varies the candidate count"
        )
    horizon = int(env.horizon_ms)
    spec = GenomeSpec(
        [
            GeneSpec("attack_start", 0.0, float(horizon - 1), integer=True),
            GeneSpec("attack_dur", 1.0, float(horizon), integer=True),
        ]
    )
    opt = make_optimizer(optimizer, spec, env.n_replicas, seed=seed)
    obj = get_objective(objective)
    if recorder is None:
        recorder = get_recorder()
    n_steps = horizon // env.decision_ms
    for _ in range(generations):
        pop = opt.ask()
        windows = np.stack(
            [
                [spec.decode(v)["attack_start"] for v in pop],
                [
                    spec.decode(v)["attack_start"] + spec.decode(v)["attack_dur"]
                    for v in pop
                ],
            ],
            axis=1,
        )
        env.reset()
        reward = np.zeros(env.n_replicas)
        t = 0
        for _step in range(n_steps):
            active = (windows[:, 0] <= t) & (t < windows[:, 1])
            _obs, reward, _info = env.step(active.astype(np.int32))
            t += env.decision_ms
        scores = np.array(
            [obj({"reward_ratio": float(r)}, horizon) for r in reward]
        )
        opt.tell(pop, scores)
        recorder.record(
            "search-generation", search="env-policy", gen=opt.generation - 1,
            evals=len(pop), best_gen_score=float(scores.max()),
            champion_score=float(opt.best_score),
        )
        SEARCH_COUNTERS["generations_total"] += 1
        SEARCH_COUNTERS["evals_total"] += len(pop)
    return opt
