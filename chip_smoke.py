"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--phases kernels,identity,...]

Phases, each printing one JSON line; any failure raises and exits non-zero
(`--phases` runs a subset while developing; the default runs them all):

  1. device     require CUDA; print the card's name and power limit
                (nvidia-smi) on a line of its own
  2. build      build every hand-written kernel from ops/csrc with nvcc for
                sm_90a, one nvcc per source, all started together
  3. kernels    hold each kernel equal to its plain PyTorch version on the
                card over odd shapes, all-zero / all-ones / top-bit rows and
                the main paths' shapes — the fused forms (popcount_binop,
                cand_score, lowest_set_bit_andnot) also over the three ops,
                broadcast on either side, sliced rows like _commit's sig_b
                and K in {1, 2, 8}; both pack forms also past 16 words a
                row (W up to 1056), pack_bool_words also on bases off a
                4-byte boundary; pack_occupied over widths, shifts across
                the wrap and past W, signed fills and strided rows; time
                kernel, plain version and bound at the main paths' shapes,
                the popcount family at
                every width bucket of the flagship, pack_bool_words also at
                [262144, 512] for bandwidth, pack_occupied at PingPong's
                and Dfinity's wheels beside the composition it replaces
                (> 0, roll, pack_bool_words); then (aggregation_shapes)
                cand_score with K = 10, 8 and 1, popcount_binop and
                lowest_set_bit at every width bucket of GSF at 2048 nodes
                x 32 replicas, and pack_bool_words on P2PHandel's payload
                rows [R*N, 120] and [R*N*P, 120] at R = 256; then
                (eth2_shapes) HandelEth2's sites at 256 nodes x R = 16:
                popcount_words on the _card rows [R*N*P*L, 64], and the
                sizeIfMerged counts of _select over [R, N, P, L, K, H]
                candidate rows as the port computes them — popcount_words
                + popcount_binop "and"/"or" with the node rows broadcast
                over K, and the three together; then (paxos_shapes) the
                occupancy forms at Paxos's wheel, R = 2048:
                pack_occupied on [R, 512] int32 fills, lowest_set_bit and
                popcount_words on the packed [R, 16] words
  4. identity   the port on the CPU (plain versions) and on CUDA
                (kernels), each side in worker processes (three on the
                CPU, six on the card, all at once), give identical
                state in every leaf: batched Handel at 64
                nodes x 2 replicas x 300 ms, flagship-shaped and with
                byzantine_suicide; PingPong at 64 nodes x 2 x 300 ms;
                Dfinity (default) x 2 x 5000 ms; GSF at 256 nodes x 2 x
                300 ms; P2PHandel (72 nodes) x 2 x 1500 ms; HandelEth2 at
                32 nodes x 2 x 700 ms; SanFermin at 64 nodes x 2 x 1000 ms;
                CasperIMD at its defaults (83 nodes, max_heights 16) x 2 x
                24000 ms with the "wf" and "sf" producers and x 2 x 40000
                ms under the AWS and IC3 models; Paxos x 2 x 5000 ms with 3 and with 5
                acceptors; Slush and Snowflake (100 nodes) x 2 x 4000 ms;
                P2PFlood (100 nodes, 3 floods) x 2 x 2001 ms;
                OptimisticP2PSignature (64 nodes, threshold 56, 10
                connections) x 2 x 1500 ms; SanFerminCappos (64 nodes,
                threshold 32, 4 candidates) x 2 x 1000 ms; ENRGossiping's
                churn configuration (ENR_CHURN: 24 nodes, 31 slots) x 2 x
                12000 ms, the card's only check of births, exits and
                capability changes (both exits fire by 10000 ms); and
                (IDENTITY_RUNS) ETHPoW's four strategies at 10 miners x 2
                x 600000 ms through the event loop, 20 BatchedMinerEnv
                steps of 1000 ms, PingPong at 64 nodes x 2 x 300 ms under
                every fault lane (all_lanes_plan) and the flagship-shaped
                Handel at 64 nodes x 2 x 300 ms under a silence bloc;
                the telemetry cases: PingPong at 64 nodes x 2 x 300 ms
                on the wheel with telemetry on (TELE_CFG), the same under
                all_lanes_plan, and the flagship-shaped Handel at 64
                nodes with telemetry on a batch whose clocks are 0 and 7
                ms (per-replica clock groups), 100 ms; the cities corner
                of logStartTime at 64 nodes (CITIES builder, UniformSpeed,
                Tor, the city matrix with jitter) and the tor battery's
                0.5 point at 32 nodes, each x 2 x 400 ms; run_fault_sweep
                over PingPong at 64 nodes with a duplicated plan, its out
                state and records; a 2-generation ES search campaign on
                the registry's 64-node Handel (200 ms, population 4), its
                report as JSON (less wall seconds and counters), with no
                kernel library built or loaded after its first
                generation; flagship_params(64) Handel x 2 saved at tick
                100 through a CheckpointManager, loaded and run 100 more
                ticks (equal to the uninterrupted run on each side); and
                optimize_env_policy on BatchedAttackEnv(n_replicas=4,
                decision_ms=200, horizon_ms=600), 2 generations: best_vec
                and best_score
  5. flagship   the Handel main path: make_handel(flagship_params(4096)),
                replicate_state(R=16), run_ms_batched in 20-ms chunks up to
                1000 ms with stop_when_done; every live node must finish and
                popcount_words, popcount_binop and cand_score must have
                launched in this run
  5b. telemetry the flagship again with the telemetry side-car
                (make_handel(flagship_params(4096), telemetry=TELE_CFG):
                TelemetryConfig(snapshots=128, snapshot_every_ms=10)) on
                replicas 0-3 of its seeds (R = 4: both runs are host-bound,
                so R = 16 would only take longer), for exactly the
                flagship phase's executed ticks, then the rest of the
                horizon with stop_when_done, with tele_profile (ticks
                100-109, stop test on, as the flagship's window) inside
                the run: every non-tele leaf equals replicas 0-3 of the
                flagship phase's final states, every node is done, sent ==
                delivered + discarded + dropped + pending per replica with
                the exact store census, the ring's done counts equal
                done_at's CDF at each written slot's tick, the popcount
                family launches; ms and kernels a tick beside the plain
                flagship's
  6. profile    ticks 100-109 of the flagship run in a torch.profiler
                window: kernels and device time per tick,
                the device's busy share of a tick, the ops that take the
                device time and each hand-written kernel's device time by
                name, and the profiler's own seconds.  Every profile window
                below sits inside its run, and its ticks or iterations are
                left out of the run's wall time.  Every window is read
                from the raw Kineto events (`_window_events`), which gives
                the numbers torch's own processing gives at a fraction of
                its cost; the p2pflood window holds the two readings equal
  7. sweep      BASELINE config 3 through the port's run_sweep: Handel at
                4096 nodes under default_params, byzantineSuicide at 0,
                5, 10, 15, 20 and 25% (none at 0%), R = 4 a point,
                SWEEP_MS (1400, cut from 3000) with stop_when_done.  The
                threshold is traced, so run_sweep runs six groups; each
                runs as run_sweep([config], seed0=1000 * i) (the seeds
                its rows have in the whole list) in a worker process,
                all at once, with the cities run.  Every group's ticks,
                ms a tick, launches and peak memory; sweep_profile is
                ticks 100-109 of the 10% group.  Every live node of every
                row done but where the JAX package leaves nodes undone
                at the same seeds (SWEEP_UNDONE), nothing dropped, the
                25% point's done_at_avg above the 0% point's, the
                popcount family and (from 5%) lowest_set_bit_andnot
                launched, and row 0 of each point equal to the JAX
                package's at its group's stop tick (SWEEP_R0); one CSV
                row a point.  Then lowest_set_bit and
                lowest_set_bit_andnot are timed on the 10% group's own
                eligibility rows (byz, bl) at tick 100, every width bucket
  7b. cities    log_start_time_configs(4096, dead=0.2, tor=0.2)[2] (the
                allScenarios "111" corner at levelWaitTime 50: the CITIES
                builder with UniformSpeed and Tor, the city matrix with
                jitter, a 100-ms desynchronized start) through run_sweep,
                R = 4, 300 ms: nothing dropped, the popcount family
                launched, row 0 equal to the JAX package's (CITIES_R0)
  7c. search    two tasks queued after the sweep's groups and the cities
                run in the same pool of seven processes, so they take the
                slots the 0% group and the cities run free: (a) the JAX
                package's reference p2pflood campaign (SEARCH_CAMPAIGN:
                P2PFlood at the reference's 100 nodes, 1000 ms, ES,
                population 6, 3 generations, seed 0) through
                SearchDriver on CUDA, interrupted: a first driver runs
                generation 0 into a checkpoint directory and is dropped,
                a second resumes at generation 1 and runs to 3; the config
                digest, the champion (score, plan digest, seed0, found at
                generation 0) and the best score of each generation must
                be the JAX package's, no kernel library may be built or
                loaded after the first generation, and the pin
                p2pflood_es_s0.json replays through verify_regression to
                its exact score with the static baselines re-scored to
                exactly the pinned ones; each generation's eval seconds,
                loop iterations, ms an iteration and launches, and evals/s
                over the campaign; (b) the pin handel_es_s0.json (the
                registry's 64-node Handel, 1500 ms) replayed the same way
                to 3000.0 and its pinned baselines, popcount_words,
                popcount_binop and cand_score launched, ms and launches a
                tick
  8. pingpong   the event-driven main path: make_pingpong(1000), R=4096,
                run_ms_batched(700, stop_when_done) on the time wheel and
                the consensus-jump loop; every witness must count 1000
                pongs, nothing may drop, and pack_occupied, lowest_set_bit
                and popcount_words must have launched in this run
  9. pp_profile a 10-iteration window from iteration 100 of the PingPong
                run, with pack_occupied's device time
 10. faults_pingpong  the same PingPong run with its first half of
                replicas under all_lanes_plan (10% of the nodes crash at
                100 ms and recover at 400, a two-group partition 50-250
                ms, 5% drops, 1.5x latency, a silenced and a delayed
                sender) and the second half neutral, one lower_plans
                stack: every neutral replica equals the pingpong phase's
                state for its seed, replica 0 equals the JAX package's
                seed-0 run (FPP_R0), both fault counters are nonzero, and
                the occupancy kernels launch; fpp_profile inside the run
 10b. pingpong_tele  the pingpong phase's run with the telemetry side-car
                (TELE_CFG), ppt_profile inside it: every non-tele leaf
                equals the pingpong phase's final states, the store
                invariant and the ring's CDF hold per replica, the jump
                census is positive and each replica's tick census equals
                jump_stats["ticks"], pack_occupied, lowest_set_bit and
                popcount_words launch; ms and kernels an iteration beside
                the plain run's.  Then the occupancy probe:
                run_ms_occupancy (per-tick steps, no jumps) on replicas
                0-255 for 100 ms on the card and on replicas 0-3 on the
                CPU, whose marks and states must be equal
 11. dfinity    make_dfinity(max_heights=64), R=256, 15000 ms: nothing may
                drop, every replica's head height (its highest notarized
                block) reaches 4, and pack_occupied must have launched
 12. gsf        GSF at 2048 nodes (BASELINE config 2), R = 32, 1000 ms in
                20-ms chunks with stop_when_done: every node must finish,
                and the popcount family and lowest_set_bit must launch;
                gsf_profile is ticks 100-109 of its run
 13. p2phandel  P2PHandel at the reference defaults, R = 256, 1000 ms on
                the 512-row wheel (cut from running to done, 6957 ticks,
                then from 3000 ms): nothing may drop, replica 0 must give
                the JAX package's seed-0 counters at 1000 ms (P2P_R0), pack_bool_words must
                launch; p2p_profile is a 10-tick window at ticks 100-109
 14. handeleth2 HandelEth2 at 256 nodes, R = 16, 1200 ms (cut from 2000)
                on the 512-row wheel: nothing may drop, every node of
                every replica must hold 256 incoming contributions,
                replica 0 must give the JAX package's seed-0 traffic
                (ETH2_R0: 16279 received, 16705 sent), and the popcount forms must launch; eth2_profile is
                a 10-tick torch.profiler window over ticks 1000-1009 (the
                beat tick 1001 among them) inside the run
 15. sanfermin  SanFermin at 4096 nodes (BASELINE config 5 with Dfinity),
                capacity 1 << 16, R = 256, 1200 ms (cut from 3000, then
                2200): nothing may drop, and replica 0 must give the JAX
                package's seed-0 result (SF_R0: 1544 nodes past the
                threshold, thr_at P10/P50/P90 982/1101/1184); sf_profile
                is a 10-tick window over ticks 1000-1009 inside the run.  Its
                path calls no hand-written kernel (the per-ms loop reads no
                wheel occupancy summary)
 16. casper     CasperIMD at 1024 validators (BASELINE config 4: 1027
                nodes, cycle_length 4, attesters_per_round 256,
                max_heights 12), R = 16, 48000 ms on the flat store, once
                per latency model of the sweep (distance + jitter; AWS
                regions with the AWS node builder, whose latencies are all
                1 ms on the batched path, as in the JAX package; IC3):
                nothing may drop, every replica's chain is linear with 5
                blocks or more, and replica 0 must give the JAX package's
                seed-0 outcome (CASPER_R0) under each model; each model's
                casper_*_profile is its CASPER_WINDOWS window (iterations
                100-109 of distance's 2131, 11-20 of AWS's 21, 61-70 of
                IC3's 81).  Its path calls no hand-written kernel
 17. paxos      Paxos (3 acceptors, 3 proposers), R = 2048, 5000 ms with
                stop_when_done on the 512-row wheel (cut from 16384,
                71.6 s on an H100 at 700 W, then from 8192): no replica's proposers may accept two values,
                every replica must decide but those the JAX package leaves
                undecided (PAXOS_UNDECIDED), nothing may drop,
                replica 0 must give the JAX package's seed-0 run (done_at
                487/912/226, value 95, 77 received, 78 sent), and
                pack_occupied, lowest_set_bit and popcount_words must
                launch; paxos_profile is a 10-iteration window from
                iteration 100
 18. slush      Slush at the reference main (100 nodes, M 5, K 7, alpha
                4/7), R = 1024, 4000 ms with stop_when_done on the 512-row
                wheel: every node of every replica colored and none
                querying, nothing dropped, replica 0 equal to the JAX
                package's seed-0 run (AV_R0), and pack_occupied,
                lowest_set_bit and popcount_words launched in this run;
                slush_profile is a 10-iteration torch.profiler window from
                iteration 100 inside the run
 19. snowflake  the same for Snowflake (B = 3) and snowflake_profile
 20. p2pflood   P2PFlood at the reference defaults (100 nodes, 10 dead, 10
                peers), R = 1024, 5000 ms with stop_when_done on the flat
                store (capacity 1 << 13): every live node reached, nothing
                dropped, replica 0 equal to the JAX package's seed-0 run
                (FLOOD_R0); p2pflood_profile inside the run.  No
                hand-written kernel on its path
 21. optimistic OptimisticP2PSignature at the reference's 1000 nodes
                (threshold 501, 13 connections, pairing time 3), R = 4,
                1500 ms with stop_when_done on the flat store at capacity
                1 << 23 (134M slots; 1 << 22 drops): every node of every
                replica done, nothing dropped, replica 0 equal to the JAX
                package's seed-0 run (OPT_R0); optimistic_profile inside
                the run.  No hand-written kernel on its path
 22. cappos     SanFerminCappos at 1024 nodes (threshold 512, 50
                candidates), R = 16, 500 ms (cut from 1000) on the 512-row wheel at
                capacity 1 << 20 (4096 slots a row; 1 << 19 drops), a fixed
                depth since six nodes never finish: nothing dropped,
                replica 0 equal to the JAX package's seed-0 run
                (CAPPOS_R0); cappos_profile is a 10-tick window over ticks
                300-309 inside the run.  No hand-written kernel on its path
 23. enr        ENRGossiping at the reference main (ENRParameters(), the
                main's 10-hour horizon: 131 slots), capacity 1 << 12 on the
                flat store, R = 1024, 60000 ms at a fixed depth (cut from
                the main's 36000000 ms, hundreds of thousands of
                iterations; every node is done from t = 0, so
                stop_when_done would stop at once): nothing dropped; in
                every replica 51 slots alive and the adjacency symmetric,
                loop-free and without a link on a dead slot; replica 0
                equal to the JAX package's seed-0 run (ENR_R0);
                enr_profile is a 10-iteration window from iteration 100
                inside the run.  No hand-written kernel on its path
 24. ethpow     ETHPoW at the reference's 10 miners, b_max 512, R = 1024,
                150000 ms (cut from try_miner's hour, then from 600000
                and 300000 ms: the event loop is host-bound and the time
                limit is shared),
                honest and under ETHSelfishMiner and ETHSelfishMiner2 at
                45%: nothing overflows, the selfish mean revenue ratio is
                above 0.5, replica 0 equals the JAX package's seed-0 run
                (ETH_R0); each config's ethpow_<config>_profile is a
                10-iteration window from iteration 100.  The
                ethpow_x_range line: the smallest and largest argument
                x = -hp/cand_diff of every threshold the three runs took
                (tracked on the card, read once at the end), which must
                lie in the covered range -x in EXP_COVERED = [2^-20,
                2^-6), where exp_f32 is XLA's exp bit for bit; and the
                thresholds on CUDA against the CPU over every float32 of
                that range (117 440 512 arguments), which must be equal.
                No hand-written kernel on its path
 25. miner_env  BatchedMinerEnv at create_agent's configuration (CITIES
                builder, NetworkFixedLatency(1000), 10 miners, agent at
                45%), R = 1024, 150 steps of 1000 ms (cut from 600: the
                time limit) under miner_policy (release everything when
                behind, else withhold): nothing overflows, replica 0's
                last observation equals the JAX environment's (MINER_R0);
                miner_env_profile is steps 100-104.  No hand-written
                kernel on its path
 26. attack_env BatchedAttackEnv on make_handel(flagship_params(4096)),
                R = 16, 100 ms steps to 500 ms (cut from 600: the time
                limit), replicas 0-7 silent on every step and 8-15
                never: the never-silent replicas' done_at equals the
                flagship phase's where it is below 500 and is 0 where
                not, the silent ones' undone share is not below the
                others', and
                popcount_words, popcount_binop and cand_score launch;
                attack_profile is ticks 200-209 inside the run
 26b. durable   scripts/durable_smoke.py's proof on the flagship, in three
                child processes of this script (`--durable-child`) run
                one after another on a thread, beside the phases from
                dfinity on: make_handel(flagship_params(4096),
                telemetry=TELE_CFG) through run_fault_sweep over a
                control plan and a crash plan (10% of the nodes down from
                100 ms, back at 300), R = 2, 400 ms.  The reference runs it
                straight; the victim runs it resumable in 100-ms chunks
                under the Supervisor (checkpoint_dir, a watchdog, a
                tail-safe FlightRecorder JSONL beside the checkpoints, a
                TimeSeriesStore and an InvariantSentinel through
                supervisor_kw) and SIGKILLs itself in the heartbeat after
                chunk 2; the resume is the victim's command line again.
                The resume must start from step 2 and run 2 chunks, give
                the reference's final state in every leaf (tele and faults
                included) and records, row 0 the JAX package's seed-0 row
                (DURABLE_R0, a digest of every leaf among its numbers);
                the crash row counts faults; the recorder tells one story
                under one run_id (admission, chunk-end over all 4 chunks
                with tick counters, the checkpoints, the kill, the resume,
                run-complete); the restored time series holds 4 chunk
                samples; the sentinel raises nothing against
                CAPACITY.json's handel@4096; the same sweep at 200-ms
                chunks on the victim's directory raises
                ResumeMismatchError before any chunk; the resume runs nvcc
                zero times and launches the popcount family.  Prints each
                run's ticks, ms and popcount launches a tick, seconds and
                bytes a checkpoint, the restore's seconds and
                chunk_time_histogram
 27. phase_seconds  each phase's wall seconds (profiles and checks included;
                telemetry and pingpong_tele among them; `durable` is the
                wait for its thread after the last phase, `durable_beside`
                its own seconds)
 28. launches_by_path  each path's launch count of every form
 29. kernels    one line listing every ported kernel with its numbers

Every run is under torch.inference_mode() (the worker processes' too).
The last line is {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import atexit
import contextlib
import gc
import hashlib
import itertools
import json
import multiprocessing
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from wittgenstein_tpu_torch.core.registries import builder_name
from wittgenstein_tpu_torch.engine import BatchedNetwork, map_state, replicate_state
from wittgenstein_tpu_torch.engine.checkpoint import CheckpointManager, _host_leaves, save_state
from wittgenstein_tpu_torch.faults import FaultConfig, FaultPlan, lower_plans
from wittgenstein_tpu_torch.interop import state_to_numpy
from wittgenstein_tpu_torch.ops import bitops, kernels
from wittgenstein_tpu_torch.protocols.casper import CasperParameters
from wittgenstein_tpu_torch.protocols.casper_batched import make_casper
from wittgenstein_tpu_torch.protocols.dfinity_batched import make_dfinity
from wittgenstein_tpu_torch.protocols.enr_batched import make_enr
from wittgenstein_tpu_torch.protocols.enr_gossiping import ENRParameters
from wittgenstein_tpu_torch.protocols.ethpow import ETHPoWParameters
from wittgenstein_tpu_torch.protocols.ethpow_batched import (
    EXP_COVERED,
    BatchedEthPow,
    exp_f32,
    replicate_ethpow,
)
from wittgenstein_tpu_torch.protocols.ethpow_env import BatchedMinerEnv, chain_count
from wittgenstein_tpu_torch.protocols.handel_env import BatchedAttackEnv
from wittgenstein_tpu_torch.protocols.gsf import GSFSignatureParameters
from wittgenstein_tpu_torch.protocols.gsf_batched import BatchedGSF, make_gsf
from wittgenstein_tpu_torch.protocols.handel import HandelParameters, flagship_params
from wittgenstein_tpu_torch.protocols.handel_batched import BatchedHandel, make_handel
from wittgenstein_tpu_torch.protocols.handeleth2 import HandelEth2Parameters, handeleth2_roles
from wittgenstein_tpu_torch.protocols.handeleth2_batched import BatchedHandelEth2, make_handeleth2
from wittgenstein_tpu_torch.protocols.p2phandel import P2PHandelParameters
from wittgenstein_tpu_torch.protocols.p2phandel_batched import make_p2phandel
from wittgenstein_tpu_torch.protocols.paxos import PaxosParameters
from wittgenstein_tpu_torch.protocols.paxos_batched import make_paxos
from wittgenstein_tpu_torch.protocols.pingpong_batched import make_pingpong
from wittgenstein_tpu_torch.protocols.sanfermin import SanFerminSignatureParameters
from wittgenstein_tpu_torch.protocols.sanfermin_batched import make_sanfermin
from wittgenstein_tpu_torch.protocols.avalanche_batched import make_slush, make_snowflake
from wittgenstein_tpu_torch.protocols.optimistic_p2p_signature import (
    OptimisticP2PSignatureParameters,
)
from wittgenstein_tpu_torch.protocols.optimistic_p2p_signature_batched import make_optimistic
from wittgenstein_tpu_torch.protocols.p2pflood import P2PFloodParameters
from wittgenstein_tpu_torch.protocols.p2pflood_batched import make_p2pflood
from wittgenstein_tpu_torch.protocols.sanfermin_cappos import SanFerminParameters
from wittgenstein_tpu_torch.protocols.sanfermin_cappos_batched import make_sanfermin_cappos
from wittgenstein_tpu_torch.protocols.slush import SlushParameters
from wittgenstein_tpu_torch.protocols.snowflake import SnowflakeParameters
from wittgenstein_tpu_torch.scenarios.handel_scenarios import (
    CSV_FIELDS,
    log_start_time_configs,
    tor_configs,
)
from wittgenstein_tpu_torch.scenarios.sweep import (
    SweepConfig,
    default_params,
    run_fault_sweep,
    run_sweep,
)
from wittgenstein_tpu_torch.obs import (
    LIVE_BASENAME,
    FlightRecorder,
    InvariantSentinel,
    TimeSeriesStore,
    mint_context,
    read_events,
)
from wittgenstein_tpu_torch.runtime import ResumeMismatchError, Supervisor, WatchdogPolicy
from wittgenstein_tpu_torch.scenarios.regressions import (
    REGRESSIONS_DIR,
    load_regression,
    verify_regression,
)
from wittgenstein_tpu_torch.search import SearchConfig, SearchDriver, optimize_env_policy
from wittgenstein_tpu_torch.telemetry import TelemetryConfig
from wittgenstein_tpu_torch.tools.csv_formatter import CSVFormatter

HBM_BYTES_PER_S = 3.35e12  # H100 SXM peak (NVIDIA data sheet, at 700 W)
INT_OPS_PER_S = 67e12  # 32-bit rate outside the tensor cores (same sheet's fp32)
FLAGSHIP_NODES = 4096
FLAGSHIP_REPLICAS = 16
# BASELINE config 3: the Byzantine sweep (scenarios/sweep.py run_sweep)
SWEEP_NODES = 4096
SWEEP_FRACTIONS = (0.0, 0.05, 0.10, 0.15, 0.20, 0.25)
SWEEP_REPLICAS = 4
# cut from 3000 ms: every group but 5% is done by 1392 ms; one replica of
# the 5% group leaves live nodes undone at any depth (SWEEP_UNDONE), so
# that group runs to the horizon (3000 ms: 465 s on an H100 80GB HBM3 at
# 700 W, past the script's budget)
SWEEP_MS = 1400
# the 10% group, the shortest Byzantine one, carries the profile window:
# its processing (~34 s on an H100 80GB HBM3 at 700 W) made the 20% group
# the phase's longest, and adds least to the 10% group's 1140 ticks
SWEEP_PROFILE_POINT = 2
CITIES_MS = 300
# row 0 of each point at its group's stop tick (the tick after its last
# row's completion, or SWEEP_MS), and the cities run's row 0 at CITIES_MS:
# the JAX package's numbers on the CPU (scripts/torch_sweep_reference.py)
SWEEP_R0 = {
    0.0: {"ticks": 608, "done_at_min": 436, "done_at_avg": 487, "done_at_max": 570,
          "msg_rcv_min": 264, "msg_rcv_avg": 311, "msg_rcv_max": 357,
          "msg_filtered_avg": 76, "sigs_checked_avg": 16},
    0.05: {"ticks": 1400, "done_at_min": 717, "done_at_avg": 838, "done_at_max": 1023,
           "msg_rcv_min": 344, "msg_rcv_avg": 457, "msg_rcv_max": 534,
           "msg_filtered_avg": 159, "sigs_checked_avg": 82},
    0.1: {"ticks": 1140, "done_at_min": 761, "done_at_avg": 875, "done_at_max": 1113,
          "msg_rcv_min": 327, "msg_rcv_avg": 443, "msg_rcv_max": 501,
          "msg_filtered_avg": 130, "sigs_checked_avg": 95},
    0.15: {"ticks": 1243, "done_at_min": 779, "done_at_avg": 904, "done_at_max": 1089,
           "msg_rcv_min": 319, "msg_rcv_avg": 432, "msg_rcv_max": 506,
           "msg_filtered_avg": 142, "sigs_checked_avg": 105},
    0.2: {"ticks": 1195, "done_at_min": 794, "done_at_avg": 926, "done_at_max": 1123,
          "msg_rcv_min": 254, "msg_rcv_avg": 414, "msg_rcv_max": 499,
          "msg_filtered_avg": 119, "sigs_checked_avg": 109},
    0.25: {"ticks": 1392, "done_at_min": 830, "done_at_avg": 947, "done_at_max": 1391,
           "msg_rcv_min": 256, "msg_rcv_avg": 397, "msg_rcv_max": 481,
           "msg_filtered_avg": 132, "sigs_checked_avg": 114},
}
CITIES_R0 = {"done": 0, "msg_received": 137280, "msg_filtered": 0, "sigs_checked": 14966}
# live nodes each row leaves undone at SWEEP_MS, where not all are done:
# the JAX package's rows at the same seeds (1000-1003) leave the same
SWEEP_UNDONE = {0.05: [0, 0, 1, 0]}
SWEEP_POOL = 7  # worker processes of the sweep phase: six groups and the cities run
# the search phase: the JAX package's reference p2pflood campaign (its
# pin's provenance) and its two pinned champions, replayed exactly
SEARCH_CAMPAIGN = dict(protocol="p2pflood", objective="done_at", sim_ms=1000, generations=3,
                       population=6, seed=0, optimizer="es", label="p2pflood-es-s0")
SEARCH_DIGEST = "4c86b918f531f2ff"
SEARCH_CHAMPION = {"score": 1559.1, "plan_digest": "3f97e845d9ee79b96452813100a8a389",
                   "seed0": 6, "generation": 0}
SEARCH_GEN_SCORES = [1559.1, 1478.2, 1559.1]
SEARCH_PINS = {"p2pflood": "p2pflood_es_s0.json", "handel": "handel_es_s0.json"}
CHUNK_MS = 20
SIM_MS = 1000
PP_NODES = 1000
PP_REPLICAS = 4096
PP_MS = 700
# the replica counts marked "cut" below were cut (a run's replicas are
# independent; every replica-0 check holds at any count) to make room for
# the Byzantine sweep and the cities run within the script's time limit
DF_REPLICAS = 256  # cut from 1024
DF_MS = 15000
GSF_NODES = 2048
GSF_REPLICAS = 32
P2P_REPLICAS = 256  # cut from 1024
# a fixed depth, cut from running to done (6957 ticks, 144 s at 20.74 ms a
# tick on an H100 80GB HBM3 at 700 W, when the script ran 836-956 s) to
# make room for the Slush, Snowflake, P2PFlood, OptimisticP2PSignature and
# SanFerminCappos runs, then from 3000 ms for the Byzantine sweep;
# replica 0 is held to the JAX package's seed-0 counters at this depth
# (P2P_R0, scripts/torch_r0_reference.py p2phandel), where no node is
# done yet
P2P_MS = 1000
P2P_R0 = {"msg_received": 100, "msg_sent": 100, "done": 0, "verified": 200, "ver_card": 200,
          "ver_sig": 80, "peers_state": 200, "ver_done_t": 23337, "last_check": 10337}
ETH2_NODES = 256
ETH2_REPLICAS = 16  # cut from 64
# cut from 2000 ms for the Byzantine sweep: the height-1001 process is
# complete at every node by then too
ETH2_MS = 1200
# the JAX package's seed-0 traffic at ETH2_MS (scripts/torch_r0_reference.py
# handeleth2)
ETH2_R0 = {"msg_received": 16279, "msg_sent": 16705, "rr_bump": 16279, "window_min": 128,
           "window_max": 128}
SF_NODES = 4096
SF_REPLICAS = 256  # cut from 1024
# cut from 3000 ms (3000 ticks at 30.82 ms, 92 s, on an H100 80GB HBM3 at
# 700 W, when the script ran 836-956 s) to 2200 (replica 0's numbers are
# the same there: its last node reaches the threshold at 2109 ms), then
# to 1200 for the Byzantine sweep, where 1544 of replica 0's nodes have
# reached it
SF_MS = 1200
SF_CAPACITY = 1 << 16
# the JAX package's seed-0 run at SF_MS (scripts/torch_r0_reference.py
# sanfermin)
SF_R0 = {"done": 1544, "thr_at_p10_p50_p90": [982, 1101, 1184], "thr_at_min": 815,
         "thr_at_max": 1203, "msg_received": 139355, "sent_req": 86436}
SF_PROFILE_AT = 1000
PROFILE_TICKS = 10  # cut from 20: the windows' own processing
# the flagship's and GSF's windows stay at the 10 ticks they had as second
# runs: at 20 ticks inside the run the two phases took 52 s and 37 s
# beyond their runs on an H100 80GB HBM3 at 700 W (most of it the
# profiler's own processing), when the script ran 838 s
LOCKSTEP_PROFILE_TICKS = 10
PROFILE_FROM = 100  # the event-driven runs' profiled window starts here
# BASELINE config 4: CasperIMD with 1024 attesters (1027 nodes), 6 slots,
# under the three latency models of its sweep
CASPER_REPLICAS = 16  # cut from 64
CASPER_MS = 48000
CASPER_HEIGHTS = 12
CASPER_MODELS = {
    "distance": {},
    "aws": dict(node_builder_name=builder_name("AWS", True, 0.0),
                network_latency_name="AwsRegionNetworkLatency"),
    "ic3": dict(network_latency_name="IC3NetworkLatency"),
}
# each model's profiled window (first iteration, iterations) inside its
# run: the AWS run takes 21 iterations and the IC3 run 81, fewer than
# PROFILE_FROM + PROFILE_TICKS
CASPER_WINDOWS = {"distance": (PROFILE_FROM, PROFILE_TICKS), "aws": (11, 10),
                  "ic3": (61, PROFILE_TICKS)}
# the JAX package's seed-0 run of config 4, the same under every model:
# a linear chain of 5 blocks, and the re-arming timers live at the end
CASPER_R0 = {"heights": [0, 1, 2, 3, 4, 5], "blk_parent": [-1, 0, 1, 2, 3, 4],
             "blk_time": [0, 8000, 16000, 24000, 32000, 40000], "head_min": 5, "head_max": 5,
             "msg_received": 1319695, "msg_sent": 1319695, "msg_head": 1322008,
             "att_exists": 1280, "rec_att": 1314560, "reeval": 2569, "wf_on_time": 2,
             "wf_late": 0, "overflow_live": 1026, "overflow_slots": [0, 1025],
             "overflow_types": [0, 0, 1, 1024, 1, 0, 0], "overflow_arrival_sum": 65640000}
# cut from 16384, whose run took 71.6 s on an H100 80GB HBM3 at 700 W,
# past the phase's 60 s, then from 8192
PAXOS_REPLICAS = 2048
PAXOS_MS = 5000
# seeds whose proposers 0 and 1 still duel at 5000 ms (each one's commit
# rejected after the other's proposal), undecided in the JAX package too
# (tests/test_torch_paxos.py)
PAXOS_UNDECIDED = (15639, 16118)
# the JAX package's P2PHandel test parameters (small), for the identity
P2P_SMALL = dict(signing_node_count=64, relaying_node_count=8, threshold=60,
                 connection_count=12, pairing_time=20, sigs_send_period=200)
# Slush and Snowflake at the reference mains (slush.py, snowflake.py), on
# the 512-row wheel at the default capacity, run to quiescence
AV_REPLICAS = 1024  # cut from 4096
AV_MS = 4000
AV_PATHS = {
    "slush": (make_slush, lambda: SlushParameters(100, 5, 7, 4.0 / 7.0)),
    "snowflake": (make_snowflake, lambda: SnowflakeParameters(100, 5, 7, 4.0 / 7.0, 3)),
}
# replica 0 of the JAX package's seed-0 runs: every node red
AV_R0 = {
    "slush": {"color": 100, "iter": 500, "nonce": 598, "msg_received": 8400, "msg_sent": 8400},
    "snowflake": {"color": 100, "iter": 400, "nonce": 458, "msg_received": 6440,
                  "msg_sent": 6440},
}
# P2PFlood at the reference defaults (100 nodes, 10 dead, 10 peers), flat
FLOOD_REPLICAS = 1024
FLOOD_MS = 5000
FLOOD_CAPACITY = 1 << 13
# the JAX package's seed-0 run with stop_when_done: it stops at the last
# live node's done tick, 827, with 447 of the 1013 floods received
FLOOD_R0 = {"done": 90, "done_at_p10_p50_p90": [332.0, 547.5, 736.1], "done_at_max": 827,
            "msg_received": 447, "msg_sent": 1013}
# OptimisticP2PSignature at the reference's 1000 nodes (its main), flat;
# about 6 million sends a replica by 300 ms: 1 << 22 slots drop 11% of them.
# The JAX package's seed-0 run stops at tick 228 (the last node done at
# 234 = 228 + 2 * pairing time) with 2760055 sends still in flight
OPT_REPLICAS = 4  # cut from 16
OPT_MS = 1500
OPT_CAPACITY = 1 << 23
OPT_R0 = {"done": 1000, "done_at_p10_p50_p90": [162.0, 176.0, 193.0], "done_at_min": 151,
          "done_at_max": 234, "received_bits": 508744, "msg_received": 3346693,
          "msg_sent": 6106748, "pending": 2760055}
# SanFerminCappos at 1024 nodes (sigs_per_time), on the 512-row wheel with
# 4096 slots a row (1 << 19 drops); six nodes never finish, so the run
# has a fixed depth, by which it has settled
CAPPOS_REPLICAS = 16  # cut from 64
# cut from 1000 ms for the Byzantine sweep: every node that finishes has
# finished by 358 ms; replies still in flight at 500 (CAPPOS_R0)
CAPPOS_MS = 500
CAPPOS_CAPACITY = 1 << 20
CAPPOS_PROFILE_AT = 300
CAPPOS_R0 = {"done": 1018, "not_done": [311, 390, 534, 674, 841, 890],
             "done_at_p10_p50_p90": [323.0, 334.0, 346.0], "done_at_min": 313,
             "done_at_max": 358, "thr_done": 1018, "thr_at_p10_p50_p90": [308.0, 320.0, 332.0],
             "msg_received": 364734, "msg_sent": 402580, "cpl": 47}
# ENRGossiping at the reference main (enr_gossiping.py's main: cap_search
# over 10 hours, so 131 slots), on the flat store; 60000 ms reach the first
# broadcasts and their floods, link growth to max_peers 50 and the swap
# path (the first birth after t = 0 falls at 450000 ms)
ENR_REPLICAS = 1024
ENR_MS = 60_000
ENR_HORIZON = 36_000_000
ENR_CAPACITY = 1 << 12
# the JAX package's seed-0 run at 60000 ms (the same at capacity 1 << 13)
ENR_R0 = {"alive": 51, "adj_cells": 1054, "max_degree": 50, "min_alive_degree": 12,
          "id_weighted_degree": 27129, "adj_md5_12": "825afaaddcbd", "records": 9,
          "seen_cells": 459, "seen_max": 0, "msg_received": 5498, "msg_sent": 5498,
          "pending": 293, "done_at_sum": 51, "last_t": 56248, "bcast_next_min": 61528}
# a churn configuration for the identity case: births every 2000 ms,
# exits at 8560 and 9469, capability changes at 3051 and 5873
ENR_CHURN = dict(nodes=24, total_peers=4, max_peers=6, number_of_different_capabilities=5,
                 cap_per_node=2, cap_gossip_time=3000, time_to_leave=16000,
                 time_to_change=6000, changing_nodes=1, discard_time=100)
# ETHPoW: the reference's 10 miners (try_miner, create_agent), the JAX
# tests' 45% attack, b_max 512
# the telemetry side-car on the two main paths: one ring slot per 10 ms,
# enough for the flagship's 1000 ms and PingPong's 700
TELE_CFG = TelemetryConfig(snapshots=128, snapshot_every_ms=10)
TELE_REPLICAS = 4  # the telemetry phase: the flagship's replicas 0-3 (host-bound either way)
OCC_REPLICAS = 256  # pingpong_tele's occupancy probe: a slice of the run
INT32_MAX = 2**31 - 1
OCC_MS = 100
ETH_MINERS = 10
ETH_B_MAX = 512
ETH_REPLICAS = 1024  # cut from 4096
# cut from 600 000 ms (52 s for the three runs on an H100 80GB HBM3 at
# 700 W), then from 300 000, to make room for the Byzantine sweep
ETH_MS = 150_000
ETH_CONFIGS = {
    "honest": {},
    "selfish": dict(byz_class_name="ETHSelfishMiner", byz_mining_ratio=0.45),
    "selfish2": dict(byz_class_name="ETHSelfishMiner2", byz_mining_ratio=0.45),
}
# the JAX package's seed-0 run of each at ETH_MS (public tip seen by miner
# 0; scripts/torch_r0_reference.py ethpow)
ETH_R0 = {
    "honest": {"n_blocks": 19, "chain": 18, "tip": 18, "revenue_ratio": 0.05555555555555555,
               "blocks_mined": [2, 1, 2, 0, 1, 1, 5, 3, 2, 1], "overflowed": 0},
    "selfish": {"n_blocks": 22, "chain": 13, "tip": 19, "revenue_ratio": 0.8461538461538461,
                "blocks_mined": [1, 11, 1, 0, 1, 1, 2, 2, 1, 1], "overflowed": 0},
    "selfish2": {"n_blocks": 22, "chain": 13, "tip": 19, "revenue_ratio": 0.8461538461538461,
                 "blocks_mined": [1, 11, 1, 0, 1, 1, 2, 2, 1, 1], "overflowed": 0},
}
# BatchedMinerEnv at create_agent's configuration (ethpow.py:757-766)
MINER_PARAMS = dict(node_builder_name=builder_name("CITIES", True, 0),
                    network_latency_name="NetworkFixedLatency(1000)", number_of_miners=10,
                    byz_class_name="ETHMinerAgent", byz_mining_ratio=0.45)
MINER_REPLICAS = 1024  # cut from 4096
MINER_DECISION_MS = 1000
MINER_STEPS = 150  # cut from 600: the time limit (PERF.md, PR 10)
MINER_PROFILE_STEPS = 5  # ~5800 kernels a step
# the JAX environment's replica 0 after MINER_STEPS under `miner_policy`
MINER_R0 = {"advance": 8, "head_height": 7951093, "i_am_ahead": True, "lag": 0,
            "mined_block": False, "n_withheld": 2, "other_new_head": False,
            "other_private_head": False, "reward_ratio": 0.8999999761581421,
            "secret_advance": 2, "time": 150001}
# the JAX package's seed-0 PingPong(1000) under the all-lanes plan, 700 ms
FPP_R0 = {"pong": 489, "msg_received": 1084, "msg_sent": 1595, "done_at_sum": 0,
          "dropped_by_fault": [405, 106], "delayed_by_fault": [0, 568], "pending": 0,
          "time": 700}
# BatchedAttackEnv on the flagship: replicas 0-7 silent every step
ATTACK_REPLICAS = 16
ATTACK_SILENT = 8
ATTACK_DECISION_MS = 100
# cut from 600 (the flagship's 549 ticks) for the time limit; the
# flagship's nodes finish at 445 / 465 / 487 ms (P10/P50/P90), so most of
# the honest half is done by 500
ATTACK_HORIZON_MS = 500
ATTACK_PROFILE_FROM = 200  # the attack window's first tick
# the durable phase: a supervised run_fault_sweep of the flagship with
# telemetry, a control row and a crash row, killed and resumed
DURABLE_MS = 400
DURABLE_CHUNK_MS = 100
DURABLE_KILL_AFTER = 2  # the victim's heartbeat after chunk index 2 SIGKILLs it
DURABLE_CRASH = (0.10, 100, 300)  # share of the nodes down, from, back at (ms)
# a generous guard: a chunk is 100 ticks, ~10 s on an H100
DURABLE_WATCHDOG = WatchdogPolicy(chunk_deadline_s=180.0, compile_deadline_s=180.0)
DURABLE_CHILD_TIMEOUT = 600
# the JAX package's seed-0 control row at DURABLE_MS, score cache on as
# on the card (no node is done by 400 ms: the flagship's finish at
# 445-487; scripts/torch_r0_reference.py durable)
DURABLE_R0 = {"digest": "cca0f63850af203e7a0be8b39703f142", "done": 0, "done_at_sum": 0,
              "msg_received": 1104951, "msg_sent": 1104951, "sigs_checked": 57101,
              "tele_sent": [0] * 13, "tele_delivered": [0] * 13, "ticks": 400, "time": 400}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def device_info() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false — no card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    info = {
        "phase": "device",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    emit(info)
    return info


def build() -> None:
    t0 = time.perf_counter()
    kernels.build_all()
    regs = {
        lib.source.name: [ln.strip() for ln in lib.build_log.splitlines() if "registers" in ln]
        for lib in kernels.LIBRARIES
    }
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": regs})


def graph_ms(fn, reps: int = 20, iters: int = 5) -> float:
    """Device time per call of fn: `reps` calls captured in a CUDA graph
    and replayed, so host-side launch cost does not hide in the number."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (iters * reps)


def _check_cases(gen: torch.Generator):
    """Odd shapes over every width class, plus the special fills."""
    dev = "cuda"
    for w in (1, 2, 3, 4, 5, 7, 8, 9, 16, 31, 32, 33, 64, 100, 128):
        for rows in ((1,), (7,), (257,), (3, 5, 11)):
            x = torch.randint(-(2**31), 2**31, rows + (w,), generator=gen,
                              dtype=torch.int64).to(torch.int32).to(dev)
            yield x
            # sparse rows: most words zero, so lowest_set_bit lands deep
            keep = torch.rand(rows + (w,), generator=gen) < 0.05
            yield torch.where(keep.to(dev), x, 0)
            yield torch.zeros(rows + (w,), dtype=torch.int32, device=dev)
            yield torch.full(rows + (w,), -1, dtype=torch.int32, device=dev)
            yield torch.full(rows + (w,), -(2**31), dtype=torch.int32, device=dev)
    # contiguous rows that start off a 16-byte boundary take the word path
    flat = torch.randint(-(2**31), 2**31, (4 * 257 + 1,), generator=gen,
                         dtype=torch.int64).to(torch.int32).to(dev)
    for w in (1, 2, 4):
        yield flat[1 : 1 + 257 * w].view(257, w)
    # a broadcast (stride-0) operand goes through the contiguity path
    row = torch.randint(-(2**31), 2**31, (1, 64), generator=gen,
                        dtype=torch.int64).to(torch.int32).to(dev)
    yield row.expand(300, 64)


def check_kernel(kernel, fn, plain, main_shape, gen) -> dict:
    worst = 0
    for x in _check_cases(gen):
        got, want = fn(x), plain(x)
        torch.cuda.synchronize()
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"{kernel.name}: {got.dtype}{tuple(got.shape)} "
                                 f"vs plain {want.dtype}{tuple(want.shape)}")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) if got.numel() else 0
        if err:
            raise AssertionError(f"{kernel.name} disagrees with its plain version "
                                 f"at {tuple(x.shape)}: max |err| {err}")
        worst = max(worst, err)
    if kernel is kernels.LOWEST_SET_BIT:
        # occupancy rows are sparse: about 2% of the wheel's rows hold mail
        occupied = torch.rand(main_shape[:-1] + (32 * main_shape[-1],), generator=gen) < 0.02
        x = bitops.pack_bool_words_plain(occupied).cuda()
    else:
        x = torch.randint(-(2**31), 2**31, main_shape, generator=gen,
                          dtype=torch.int64).to(torch.int32).cuda()
    got, want = fn(x), plain(x)
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if err:
        raise AssertionError(f"{kernel.name} disagrees at the main-path shape: {err}")
    m, w = int(np.prod(main_shape[:-1])), main_shape[-1]
    # lowest_set_bit's work depends on the data: a row is read up to its
    # first nonzero word
    words = _words_to_first(x) if kernel is kernels.LOWEST_SET_BIT else m * w
    return _kernel_row(kernel, worst, {"shape": list(main_shape), **_timed(
        lambda: fn(x), lambda: plain(x), 4 * words + 4 * m, 2 * words)})


def _pack_cases(gen):
    """Bool operands over odd widths up to twice the wheel's 512 rows
    (past 16 words a row the walk takes a second round of steps, and at 32
    words it stores 32 at once), random, sparse, all-false and all-true,
    plus broadcast and strided views."""
    dev = "cuda"
    for w in (1, 2, 7, 31, 32, 33, 63, 64, 65, 100, 127, 128, 129, 255, 256, 257, 511, 512,
              544, 1024, 1056):
        for rows in ((), (1,), (7,), (257,), (3, 5, 11)):
            shape = rows + (w,)
            yield (torch.rand(shape, generator=gen) < 0.5).to(dev)
            yield (torch.rand(shape, generator=gen) < 0.02).to(dev)
            yield torch.zeros(shape, dtype=torch.bool, device=dev)
            yield torch.ones(shape, dtype=torch.bool, device=dev)
    yield (torch.rand((1, 100), generator=gen) < 0.5).to(dev).expand(300, 100)
    yield (torch.rand((64, 40), generator=gen) < 0.5).to(dev).t()
    # word-multiple rows on a base off a 4-byte boundary: every row takes
    # the funnel shift
    flat = (torch.rand(257 * 512 + 3, generator=gen) < 0.5).to(dev)
    for start in (1, 2, 3):
        yield flat[start : start + 257 * 512].view(257, 512)


def check_pack(gen) -> dict:
    """pack_bool_words against its plain version; timed at the event-driven
    path's shape (the wheel-occupancy rows of R = 4096 replicas) and at a
    large shape for bandwidth."""
    kernel, fn, plain = kernels.PACK_BOOL_WORDS, kernels.pack_bool_words, bitops.pack_bool_words_plain
    worst = 0
    for x in _pack_cases(gen):
        got, want = fn(x), plain(x)
        torch.cuda.synchronize()
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"{kernel.name}: {got.dtype}{tuple(got.shape)} "
                                 f"vs plain {want.dtype}{tuple(want.shape)}")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if err:
            raise AssertionError(f"{kernel.name} disagrees with its plain version "
                                 f"at {tuple(x.shape)}: max |err| {err}")
        worst = max(worst, err)
    timed = []
    for shape, plain_reps in (((PP_REPLICAS, 512), 20), ((262144, 512), 3)):
        # wheel occupancy: a few occupied rows in 512
        x = (torch.rand(shape, generator=gen) < 0.02).cuda()
        got, want = fn(x), plain(x)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{kernel.name} disagrees at {shape}")
        m, w = shape
        timed.append({"shape": list(shape), **_timed(
            lambda: fn(x), lambda: plain(x), m * w + 4 * m * ((w + 31) // 32), m * w,
            plain_reps=plain_reps)})
    path, large = timed
    return _kernel_row(kernel, worst, {**path, "large": large})


def _occupancy_fill(shape, gen, density: float = 0.02) -> torch.Tensor:
    """A wheel fill: entry counts on about `density` of the rows."""
    counts = torch.randint(1, 5, shape, generator=gen, dtype=torch.int32)
    return torch.where(torch.rand(shape, generator=gen) < density, counts, 0)


def _occupied_cases(gen):
    """(fill, shift): the CPU tests' grid of widths, shifts, fills and
    leading shapes, on the card, and widths past 16 words a row."""
    for w in (1, 31, 32, 33, 100, 128, 512, 544, 1024, 1056):
        for lead in ((), (1,), (5,), (2, 3), (257,), "transposed"):
            shape = (w, 3) if lead == "transposed" else lead + (w,)
            signed = torch.randint(-5, 3, shape, generator=gen, dtype=torch.int32)
            signed.view(-1)[::7] = -(2**31)
            fills = [torch.zeros(shape, dtype=torch.int32), _occupancy_fill(shape, gen),
                     _occupancy_fill(shape, gen, 0.7),
                     torch.randint(1, 2**31 - 1, shape, generator=gen, dtype=torch.int32),
                     signed]
            for fill in fills:
                fill = fill.cuda()
                if lead == "transposed":
                    fill = fill.t()
                for shift in (0, 1, 31, 32, w - 1, w, 3 * w + 5):
                    yield fill, shift


def check_occupied(gen) -> dict:
    """pack_occupied against its plain version; timed at PingPong's and
    Dfinity's wheels ([R, 512] int32 fills) beside the composition it
    replaces at the engine's sites, gt + roll + pack_bool_words."""
    kernel, fn, plain = kernels.PACK_OCCUPIED, kernels.pack_occupied, bitops.pack_occupied_plain
    worst = 0
    for fill, shift in _occupied_cases(gen):
        worst = max(worst, _max_err(f"pack_occupied {tuple(fill.shape)} shift {shift}",
                                    fn(fill, shift), plain(fill, shift)))
    timed = []
    for replicas in (PP_REPLICAS, DF_REPLICAS):
        fill, shift = _occupancy_fill((replicas, 512), gen).cuda(), 137
        _same(f"pack_occupied [{replicas}, 512]", fn(fill, shift), plain(fill, shift))
        m, w = fill.shape
        timed.append({"shape": [m, w], **_timed(
            lambda: fn(fill, shift), lambda: plain(fill, shift),
            4 * m * w + 4 * m * (w // 32), m * w)})
        if replicas == PP_REPLICAS:
            def composed():
                return kernels.pack_bool_words(torch.roll(fill > 0, -shift, -1))
            _same("composition [4096, 512]", composed(), fn(fill, shift))
            timed[-1]["composition_ms"] = graph_ms(composed)
    pingpong, dfinity = timed
    return _kernel_row(kernel, worst, {**pingpong, "dfinity": dfinity})


def paxos_kernels(gen) -> dict:
    """The occupancy forms at Paxos's wheel, R = PAXOS_REPLICAS:
    pack_occupied on the [R, 512] int32 fills, lowest_set_bit and
    popcount_words on the packed [R, 16] words, each against its plain
    version and timed beside its bound."""
    fill, shift = _occupancy_fill((PAXOS_REPLICAS, 512), gen).cuda(), 137
    m, w = fill.shape
    words = bitops.pack_occupied_plain(fill, shift)
    nw = words.shape[-1]
    read = _words_to_first(words)
    cases = {
        "pack_occupied": (lambda: kernels.pack_occupied(fill, shift),
                          lambda: bitops.pack_occupied_plain(fill, shift),
                          4 * m * w + 4 * m * nw, m * w),
        "lowest_set_bit": (lambda: kernels.lowest_set_bit(words),
                           lambda: bitops.lowest_set_bit_plain(words), 4 * read + 4 * m, 2 * read),
        "popcount_words": (lambda: kernels.popcount_words(words),
                           lambda: bitops.popcount_words_plain(words),
                           4 * m * nw + 4 * m, 2 * m * nw),
    }
    rows = {}
    for name, (fn, plain, bytes_moved, ops) in cases.items():
        err = _max_err(f"{name} at Paxos's wheel", fn(), plain())
        rows[name] = {"shape": list(fill.shape if name == "pack_occupied" else words.shape),
                      "max_abs_err": err, **_timed(fn, plain, bytes_moved, ops)}
    emit({"phase": "paxos_shapes", "replicas": PAXOS_REPLICAS, "rows": rows})
    return rows


def run_kernels() -> dict:
    gen = torch.Generator().manual_seed(0)
    rows = {}
    for kernel, fn, plain, shape in (
        # R*4096 nodes x K=8 candidate slots of the top level's 64 words:
        # the flagship's largest popcount operand before cand_score took
        # it, kept as the bandwidth shape the earlier rows were timed at
        (kernels.POPCOUNT, kernels.popcount_words, bitops.popcount_words_plain,
         (FLAGSHIP_REPLICAS * 4096 * 8, 64)),
        # the event-driven paths' wheel occupancy: 512 rows packed into
        # 16 words per replica
        (kernels.LOWEST_SET_BIT, kernels.lowest_set_bit, bitops.lowest_set_bit_plain,
         (PP_REPLICAS, 512 // 32)),
    ):
        rows[kernel.name] = check_kernel(kernel, fn, plain, shape, gen)
        emit({"phase": "kernel_check", **rows[kernel.name]})
    rows["pack_bool_words"] = check_pack(gen)
    emit({"phase": "kernel_check", **rows["pack_bool_words"]})
    rows["pack_occupied"] = check_occupied(gen)
    emit({"phase": "kernel_check", **rows["pack_occupied"]})
    cgen = torch.Generator(device="cuda").manual_seed(1)
    errs = check_fused(cgen)
    buckets = {"popcount_words": popcount_bucket_times(cgen), **fused_bucket_times(cgen)}
    for name, timed in buckets.items():
        emit({"phase": "bucket_times", "kernel": name, "rows": timed})
    for kernel in (kernels.POPCOUNT_BINOP, kernels.CAND_SCORE):
        # the summary row: the form's largest bucket shape
        top = max(buckets[kernel.name], key=lambda t: t["bytes"])
        rows[kernel.name] = _kernel_row(kernel, errs[kernel.name], top)
        emit({"phase": "kernel_check", **rows[kernel.name]})
    # timed on the Byzantine run's own rows once that run has made them
    rows["lowest_set_bit_andnot"] = _kernel_row(
        kernels.LOWEST_SET_BIT_ANDNOT, errs["lowest_set_bit_andnot"], {})
    return rows


def _kernel_row(kernel, err: int, timing: dict) -> dict:
    return {"name": kernel.name, "route": "cuda",
            "source": f"wittgenstein_tpu_torch/ops/csrc/{kernel.source.name}",
            "replaces": kernel.replaces, "max_abs_err": err, **timing}


def _bound(bytes_moved: int, ops: int) -> dict:
    bound_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    bound_ops = ops / INT_OPS_PER_S * 1e3
    return {"bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations"}


def _timed(fn, plain, bytes_moved: int, ops: int, plain_reps: int = 20) -> dict:
    """One timing row: kernel and plain version by CUDA-graph replay, and
    the bound from the bytes and operations the function needs."""
    kernel_ms = graph_ms(fn)
    return {"ms": kernel_ms, "plain_ms": graph_ms(plain, reps=plain_reps),
            **_bound(bytes_moved, ops), "library_ms": None, "bytes": bytes_moved,
            "gb_per_s": bytes_moved / (kernel_ms * 1e-3) / 1e9}


def _same(tag: str, got, want) -> None:
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"{tag}: kernel and plain version differ")


def flagship_buckets() -> list:
    """(levels per bucket, words per row) of each width bucket of the
    4096-node flagship: w = 1 (levels 1-6), 2, 4, ..., 64."""
    return [(b.nl, b.w_pad) for b in BatchedHandel(flagship_params(FLAGSHIP_NODES)).buckets]


def _rand_words(shape, gen) -> torch.Tensor:
    return torch.randint(-(2**31), 2**31, shape, generator=gen, dtype=torch.int64,
                         device=gen.device).to(torch.int32)


def popcount_bucket_times(gen) -> list:
    """popcount_words at every bucket shape the flagship gives it: node
    rows [R, N, nl, w], the due pair [R, N, nl, 2, w] and one level's K
    candidate slots [R, N, K, w]."""
    r, n, k = FLAGSHIP_REPLICAS, FLAGSHIP_NODES, BatchedHandel.CAND_SLOTS
    rows = []
    for nl, w in flagship_buckets():
        for site, shape in (("node_rows", (r, n, nl, w)), ("due_pair", (r, n, nl, 2, w)),
                            ("cand_slots", (r, n, k, w))):
            x = _rand_words(shape, gen)
            _same(f"popcount_words {shape}", kernels.popcount_words(x),
                  bitops.popcount_words_plain(x))
            m = x.numel() // w
            rows.append({"site": site, "shape": list(shape),
                         **_timed(lambda: kernels.popcount_words(x),
                                  lambda: bitops.popcount_words_plain(x),
                                  4 * m * w + 4 * m, 2 * m * w, plain_reps=5)})
    return rows


def _words_to_first(e: torch.Tensor) -> int:
    """Words a row is read up to: its first nonzero word, or all of it."""
    w = e.shape[-1]
    first = torch.argmax((e != 0).to(torch.uint8), dim=-1)
    return int(torch.where((e == 0).all(-1), w, first + 1).sum())


def lowest_real_rows(net, states) -> list:
    """The Byzantine run's eligibility rows byz & ~bl, per width bucket,
    from its last tick."""
    proto = net.protocol
    byz, bl = states.proto["byz"], states.proto["bl"]
    return [(proto._blocks(byz, b), proto._blocks(bl, b)) for b in proto.buckets]


def lowest_bucket_times(rows) -> list:
    """lowest_set_bit on the Byzantine run's real eligibility rows."""
    out = []
    for byz_b, bl_b in rows:
        e = byz_b & ~bl_b
        _same(f"lowest_set_bit {tuple(e.shape)}", kernels.lowest_set_bit(e),
              bitops.lowest_set_bit_plain(e))
        m, words = e.numel() // e.shape[-1], _words_to_first(e)
        out.append({"shape": list(e.shape), "nonzero_rows": int((e != 0).any(-1).sum()),
                    **_timed(lambda: kernels.lowest_set_bit(e),
                             lambda: bitops.lowest_set_bit_plain(e),
                             4 * words + 4 * m, 2 * words)})
    return out


def hand_kernel_names() -> set:
    """The __global__ functions of the hand-written sources."""
    names = set()
    for src in kernels.CSRC.glob("*.cu"):
        names.update(re.findall(r"__global__\s+void\s+(\w+)", src.read_text()))
    return names


def device_ms_by_kernel(kern, per: float) -> dict:
    """Device ms and calls per tick (or iteration) of each hand-written
    kernel, by its function name, from profiler device events."""
    ours = hand_kernel_names()
    out = {}
    for e in kern:
        m = re.match(r"(?:void\s+)?(\w+)", e.name)
        if m and m.group(1) in ours:
            row = out.setdefault(m.group(1), {"calls": 0, "device_ms": 0.0})
            row["calls"] += 1 / per
            row["device_ms"] += e.device_time / 1e3 / per
    return out


def forms_by_kernel(kern, per: float) -> dict:
    """Device ms and calls per tick of each popcount form: popcount_rows
    serves popcount_words (template OP_NONE = 0) and popcount_binop (OP 1-3),
    told apart by the first template argument of the profiler's kernel
    name; popcount_narrow is popcount_words', cand_score_rows cand_score's."""
    out = {}
    for e in kern:
        m = re.match(r"(?:void\s+)?(\w+)(?:<([^,>]*))?", e.name)
        if not m:
            continue
        fn, op = m.group(1), m.group(2) or ""
        if fn == "popcount_rows":
            words = "NONE" in op or re.sub(r"\D", "", op) == "0"
            form = "popcount_words" if words else "popcount_binop"
        else:
            form = {"popcount_narrow": "popcount_words", "cand_score_rows": "cand_score"}.get(fn)
        if form:
            row = out.setdefault(form, {"calls": 0, "device_ms": 0.0})
            row["calls"] += 1 / per
            row["device_ms"] += e.device_time / 1e3 / per
    return out


CHECK_WIDTHS = (1, 2, 3, 4, 5, 31, 32, 33, 64, 100)


def _sparse(shape, gen, density: float = 0.05) -> torch.Tensor:
    """Random words, each kept with probability `density`, else zero."""
    keep = torch.rand(shape, generator=gen, device=gen.device) < density
    return torch.where(keep, _rand_words(shape, gen), 0)


def _fills(shape, gen):
    """Random, sparse, all-zero, all-ones and sign-bit words of one shape."""
    yield _rand_words(shape, gen)
    yield _sparse(shape, gen)
    for v in (0, -1, -(2**31)):
        yield torch.full(shape, v, dtype=torch.int32, device=gen.device)


def _pair_layouts(w: int, gen):
    """(a, b) operand pairs of width w: equal shapes, either side broadcast,
    and sliced non-contiguous rows like _commit's sig_b
    (ver_sig[..., None, :w], stride 0 over the levels), with row strides
    that do and do not allow 16-byte loads."""
    b_full = _rand_words((3, 5, 7, w), gen)
    for a in _fills((3, 5, 7, w), gen):
        yield a, b_full
        yield b_full, a
    for a in _fills((3, 1, 7, w), gen):
        yield a, b_full
        yield b_full, a
    for pad in (3, 4):
        sliced = _rand_words((3, 5, w + pad), gen)[..., None, :w]
        yield sliced, b_full
        yield b_full, sliced
        yield sliced, b_full[..., :1, :]


def _max_err(tag: str, got, want) -> int:
    """Every output equal in dtype and shape; the largest |difference|,
    which must be 0."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    worst = 0
    for g, w in zip(got, want):
        if g is None and w is None:
            continue
        if g is None or w is None or g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{tag}: kernel and plain version differ in form")
        if g.numel():
            worst = max(worst, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    if worst:
        raise AssertionError(f"{tag}: kernel and plain version differ: max |err| {worst}")
    return worst


def check_fused(gen) -> dict:
    """Each fused form against its plain version over odd widths, the
    three ops, broadcast on either side, sliced rows, K in {1, 2, 8} and
    the special fills; returns each form's max |err|."""
    worst = {"popcount_binop": 0, "cand_score": 0, "lowest_set_bit_andnot": 0}
    for w in CHECK_WIDTHS:
        for a, b in _pair_layouts(w, gen):
            for op in kernels.OPS:
                worst["popcount_binop"] = max(worst["popcount_binop"], _max_err(
                    f"popcount_binop {op} {tuple(a.shape)}x{tuple(b.shape)}",
                    kernels.popcount_binop(a, b, op), bitops.popcount_binop_plain(a, b, op)))
            worst["lowest_set_bit_andnot"] = max(worst["lowest_set_bit_andnot"], _max_err(
                f"lowest_set_bit_andnot {tuple(a.shape)}x{tuple(b.shape)}",
                kernels.lowest_set_bit_andnot(a, b), bitops.lowest_set_bit_andnot_plain(a, b)))
        for k in (1, 2, 8):
            inc, ind, agg = (_sparse((3, 5, w), gen, 0.3) for _ in range(3))
            for sig in _fills((3, 5, k, w), gen):
                # an empty inc takes the |sig | inc | ind| branch; inc[:1]
                # broadcasts over the first axis
                for node_inc in (inc, torch.zeros_like(inc), inc[:1]):
                    for node_agg in (agg, None):
                        worst["cand_score"] = max(worst["cand_score"], _max_err(
                            f"cand_score {tuple(sig.shape)}",
                            kernels.cand_score(sig, node_inc, ind, node_agg),
                            bitops.cand_score_plain(sig, node_inc, ind, node_agg)))
    torch.cuda.synchronize()
    return worst


def fused_bucket_times(gen) -> dict:
    """popcount_binop and cand_score at every bucket shape of the flagship:
    _commit's sig_b | new_ind_b (sig_b a slice of ver_sig [R, N, 64],
    stride 0 over the bucket's levels), the cache fix's K slots of one
    level [R, N, K, w] and the merge's due pair [R, N, nl, 2, w]."""
    r, n, k = FLAGSHIP_REPLICAS, FLAGSHIP_NODES, BatchedHandel.CAND_SLOTS
    ver = _rand_words((r, n, 64), gen)
    binop, cand = [], []
    for nl, w in flagship_buckets():
        a = ver[:, :, None, :w]
        b = _rand_words((r, n, nl, w), gen)
        _same(f"popcount_binop {w}", kernels.popcount_binop(a, b, "or"),
              bitops.popcount_binop_plain(a, b, "or"))
        rows = r * n * nl
        binop.append({"site": "commit", "shape": [r, n, nl, w], **_timed(
            lambda: kernels.popcount_binop(a, b, "or"),
            lambda: bitops.popcount_binop_plain(a, b, "or"),
            4 * (r * n * w + rows * w) + 4 * rows, 3 * rows * w, plain_reps=5)})
        for site, lead, slots in (("cache_fix", (r, n), k), ("due_pair", (r, n, nl), 2)):
            sig = _rand_words(lead + (slots, w), gen)
            inc, ind, agg = (_sparse(lead + (w,), gen, 0.3) for _ in range(3))
            _same(f"cand_score {site} {w}", kernels.cand_score(sig, inc, ind, agg),
                  bitops.cand_score_plain(sig, inc, ind, agg))
            nodes = int(np.prod(lead))
            words = nodes * slots * w
            cand.append({"site": site, "shape": list(lead) + [slots, w], **_timed(
                lambda: kernels.cand_score(sig, inc, ind, agg),
                lambda: bitops.cand_score_plain(sig, inc, ind, agg),
                4 * (words + 3 * nodes * w) + 16 * nodes * slots, 11 * words, plain_reps=5)})
    return {"popcount_binop": binop, "cand_score": cand}


def andnot_bucket_times(rows) -> list:
    """lowest_set_bit_andnot on the Byzantine run's real (byz, bl) rows."""
    out = []
    for byz_b, bl_b in rows:
        _same(f"lowest_set_bit_andnot {tuple(byz_b.shape)}",
              kernels.lowest_set_bit_andnot(byz_b, bl_b),
              bitops.lowest_set_bit_andnot_plain(byz_b, bl_b))
        m, words = byz_b.numel() // byz_b.shape[-1], _words_to_first(byz_b & ~bl_b)
        out.append({"shape": list(byz_b.shape), **_timed(
            lambda: kernels.lowest_set_bit_andnot(byz_b, bl_b),
            lambda: bitops.lowest_set_bit_andnot_plain(byz_b, bl_b),
            8 * words + 5 * m, 3 * words)})
    return out


def gsf_buckets() -> list:
    """(levels per bucket, words per row) of each width bucket of GSF at
    2048 nodes: w = 1 (levels 1-6), 2, 4, ..., 32."""
    return [(b.nl, b.w_pad) for b in BatchedGSF(GSFSignatureParameters(node_count=GSF_NODES)).buckets]


def _onehot_words(shape, gen) -> torch.Tensor:
    """[..., w] words with one random bit set per row (GSF's individual
    candidates)."""
    w = shape[-1]
    pos = torch.randint(0, 32 * w, shape[:-1], generator=gen, device=gen.device, dtype=torch.int32)
    ar = torch.arange(w, dtype=torch.int32, device=gen.device)
    return torch.where(ar == (pos >> 5)[..., None], (1 << (pos & 31))[..., None], 0)


def aggregation_kernels(gen) -> dict:
    """The forms at the shapes GSF at 2048 nodes x R = 32 and P2PHandel x
    R = 1024 give them, each held against its plain version (max |err|
    0) and timed by CUDA-graph replay: cand_score with K = 10 (the
    delivery merge), 8 (the selection) and 1 (the one-hot individual) and
    agg = the individuals row; popcount_binop's a & ~b at full width and
    a & b per bucket; lowest_set_bit on sparse pending rows per bucket;
    pack_bool_words on the verified rows [R*N, 120] and on [R*N*P, 120].
    Returns each form's rows and max |err|."""
    r, n = GSF_REPLICAS, GSF_NODES
    rows = {"cand_score": [], "popcount_binop": [], "lowest_set_bit": [], "pack_bool_words": []}
    errs = dict.fromkeys(rows, 0)

    def add(form, tag, shape, fn, plain, bytes_moved, ops, **extra):
        errs[form] = max(errs[form], _max_err(f"{form} {tag} {shape}", fn(), plain()))
        rows[form].append({"site": tag, "shape": list(shape), **extra,
                           **_timed(fn, plain, bytes_moved, ops, plain_reps=2)})

    a, b = _rand_words((r, n, n // 32), gen), _sparse((r, n, n // 32), gen, 0.5)
    m = r * n
    add("popcount_binop", "commit_absorb", tuple(a.shape),
        lambda: kernels.popcount_binop(a, b, "andnot"),
        lambda: bitops.popcount_binop_plain(a, b, "andnot"),
        8 * m * (n // 32) + 4 * m, 3 * m * (n // 32))
    for nl, w in gsf_buckets():
        vb = _sparse((r, n, nl, w), gen, 0.5)
        ib = _sparse((r, n, nl, w), gen, 0.05)
        nodes = r * n * nl
        for tag, k in (("deliver", 10), ("select", 8), ("select_individual", 1)):
            sig = (_onehot_words((r, n, nl, k, w), gen) if k == 1
                   else _sparse((r, n, nl, k, w), gen, 0.5))
            words = nodes * k * w
            add("cand_score", tag, tuple(sig.shape),
                lambda: kernels.cand_score(sig, vb, ib, ib),
                lambda: bitops.cand_score_plain(sig, vb, ib, ib),
                4 * (words + 2 * nodes * w) + 16 * nodes * k, 11 * words)
        sigs = _rand_words((r, n, nl, w), gen)
        add("popcount_binop", "commit_disjoint", tuple(sigs.shape),
            lambda: kernels.popcount_binop(sigs, vb, "and"),
            lambda: bitops.popcount_binop_plain(sigs, vb, "and"),
            8 * nodes * w + 4 * nodes, 3 * nodes * w)
        pend = _sparse((r, n, nl, w), gen, 0.02)
        read = _words_to_first(pend)
        add("lowest_set_bit", "select_pending", tuple(pend.shape),
            lambda: kernels.lowest_set_bit(pend), lambda: bitops.lowest_set_bit_plain(pend),
            4 * read + 4 * nodes, 2 * read, nonzero_rows=int((pend != 0).any(-1).sum()))
    n_p2p, peers = 120, 54  # P2PHandelParameters(): 100 + 20 nodes, max degree 54
    for tag, lead in (("verified", P2P_REPLICAS * n_p2p),
                      ("per_peer", P2P_REPLICAS * n_p2p * peers)):
        bits = torch.rand((lead, n_p2p), generator=gen, device=gen.device) < 0.9
        add("pack_bool_words", tag, tuple(bits.shape),
            lambda: kernels.pack_bool_words(bits), lambda: bitops.pack_bool_words_plain(bits),
            lead * n_p2p + 4 * lead * 4, lead * n_p2p)
    for form, timed in rows.items():
        emit({"phase": "aggregation_shapes", "kernel": form, "max_abs_err": errs[form],
              "rows": timed})
    return {"rows": rows, "errs": errs}


def sf_params(n: int) -> SanFerminSignatureParameters:
    """The form of SanFermin's scenario main (sanfermin.py:339 of the JAX
    package): threshold n, pairing 2 ms, 48-byte signatures, 300-ms reply
    timeout, one extra candidate."""
    return SanFerminSignatureParameters(n, n, 2, 48, 300, 1, False, None, None)


def eth2_kernels(gen) -> dict:
    """HandelEth2's popcount sites at 256 nodes x R = 64, each held against
    its plain version and timed by CUDA-graph replay: popcount_words on
    the _card rows (H * nw = 64 words); the sizeIfMerged counts of
    _select over the [R, N, P, L, K, H] candidate rows of nw = 8 words —
    popcount_words (|cand|) and popcount_binop "and"/"or" with the node
    rows broadcast over K, the port's merge_counts, also timed whole.
    Returns the rows and each form's max |err|."""
    params = HandelEth2Parameters(node_count=ETH2_NODES)
    proto = BatchedHandelEth2(params, handeleth2_roles(params)[1])
    r, n, p_, nl, k, h, nw = (ETH2_REPLICAS, ETH2_NODES, 3, proto.nl, proto.CAND_SLOTS, 8,
                              proto.nw)
    lead = (r, n, p_, nl)
    nodes = int(np.prod(lead)) * h  # node rows [R, N, P, L, H]
    m = nodes * k  # candidate rows
    inc = _sparse(lead + (h, nw), gen, 0.3)
    ind = inc & _sparse(lead + (h, nw), gen, 0.6)
    cand = _sparse(lead + (k, h, nw), gen, 0.2)
    rows, errs = [], {"popcount_words": 0, "popcount_binop": 0}

    def add(form, site, shape, fn, plain, bytes_moved, ops, plain_reps=1):
        errs[form] = max(errs[form], _max_err(f"{form} {site}", fn(), plain()))
        rows.append({"kernel": form, "site": site, "shape": list(shape),
                     **_timed(fn, plain, bytes_moved, ops, plain_reps=plain_reps)})

    card = inc.reshape(-1, h * nw)
    add("popcount_words", "card", card.shape, lambda: kernels.popcount_words(card),
        lambda: bitops.popcount_words_plain(card), 4 * card.numel() + 4 * card.shape[0],
        2 * card.numel())
    add("popcount_words", "select_av_c", cand.shape, lambda: kernels.popcount_words(cand),
        lambda: bitops.popcount_words_plain(cand), 4 * m * nw + 4 * m, 2 * m * nw)
    for op, node in (("and", inc), ("or", ind)):
        a = node[..., None, :, :]
        add("popcount_binop", f"select_{op}", cand.shape,
            lambda: kernels.popcount_binop(a, cand, op),
            lambda: bitops.popcount_binop_plain(a, cand, op),
            4 * (m * nw + nodes * nw) + 4 * m, 3 * m * nw)
    # the whole of the port's route: the three counts together
    rows.append({"kernel": "merge_counts", "site": "popcount_binop_route",
                 "shape": list(cand.shape),
                 "ms": graph_ms(lambda: proto.merge_counts(inc, ind, cand))})
    emit({"phase": "eth2_shapes", "max_abs_err": errs, "rows": rows})
    return {"rows": rows, "errs": errs}


def _leaf_diff(a: dict, b: dict) -> list:
    bad = []
    for f, va in a.items():
        vb = b[f]
        if isinstance(va, dict):
            if set(va) != set(vb):
                bad.append(f"proto keys {sorted(set(va) ^ set(vb))}")
            for k in va:
                if va[k].dtype != vb[k].dtype or not np.array_equal(va[k], vb[k]):
                    bad.append(f"proto.{k}")
        elif isinstance(va, np.ndarray):
            if va.dtype != vb.dtype or not np.array_equal(va, vb):
                bad.append(f)
    return bad


# identity cases: (build on a device, ms, chunk); each runs 2 replicas.
# Longest first (the first eleven's CUDA sides took 15-36 s each on an
# H100 80GB HBM3 at 700 W, the CPU sides about half that), so that the
# worker pools finish together
IDENTITY = {
    "dfinity": (lambda dev: make_dfinity(device=dev), 5000, 5000),
    "cappos": (lambda dev: make_sanfermin_cappos(SanFerminParameters(64, 32, 2, 48, 150, 4),
                                                 device=dev), 1000, 500),
    "sanfermin": (lambda dev: make_sanfermin(sf_params(64), device=dev), 1000, 500),
    "enr": (lambda dev: make_enr(ENRParameters(**ENR_CHURN), horizon_ms=12_000, capacity=1024,
                                 device=dev), 12000, 12000),
    "slush": (lambda dev: make_slush(AV_PATHS["slush"][1](), device=dev), 4000, 4000),
    "snowflake": (lambda dev: make_snowflake(AV_PATHS["snowflake"][1](), device=dev),
                  4000, 4000),
    "casper_wf": (lambda dev: make_casper(max_heights=16, device=dev), 24000, 24000),
    "casper_sf": (lambda dev: make_casper(max_heights=16, byz_variant="sf", device=dev),
                  24000, 24000),
    # the cities path: CITIES builder, UniformSpeed, Tor, the city matrix
    # with jitter, desynchronized start
    "cities_start_time": (lambda dev: make_handel(log_start_time_configs(
        64, dead=0.2, tor=0.2)[2].params, score_cache=True, device=dev), 400, 200),
    "p2phandel": (lambda dev: make_p2phandel(P2PHandelParameters(**P2P_SMALL), device=dev),
                  1500, 500),
    # the tor battery's 0.5 point
    "tor_half": (lambda dev: make_handel(tor_configs(32)[5].params, score_cache=True,
                                         device=dev), 400, 200),
    "handeleth2": (lambda dev: make_handeleth2(HandelEth2Parameters(node_count=32),
                                               device=dev), 700, 350),
    "gsf": (lambda dev: make_gsf(GSFSignatureParameters(node_count=256, threshold=253),
                                 device=dev), 300, 100),
    "byzantine_suicide": (lambda dev: make_handel(HandelParameters(
        node_count=64, nodes_down=16, threshold=47, byzantine_suicide=True),
        score_cache=True, device=dev), 300, 100),
    "p2pflood": (lambda dev: make_p2pflood(P2PFloodParameters(msg_count=3), device=dev),
                 2001, 2001),
    "flagship_shaped": (lambda dev: make_handel(flagship_params(64), score_cache=True,
                                                device=dev), 300, 100),
    "optimistic": (lambda dev: make_optimistic(OptimisticP2PSignatureParameters(64, 56, 10, 1),
                                               device=dev), 1500, 1500),
    "paxos": (lambda dev: make_paxos(device=dev), 5000, 5000),
    "paxos_5_3": (lambda dev: make_paxos(PaxosParameters(acceptor_count=5), device=dev),
                  5000, 5000),
    "casper_ic3": (lambda dev: make_casper(CasperParameters(**CASPER_MODELS["ic3"]),
                                           max_heights=16, device=dev), 40000, 40000),
    "pingpong": (lambda dev: make_pingpong(64, device=dev), 300, 300),
    "casper_aws": (lambda dev: make_casper(CasperParameters(**CASPER_MODELS["aws"]),
                                           max_heights=16, device=dev), 40000, 40000),
}


def all_lanes_plan(n: int) -> FaultPlan:
    """Every fault lane at once: 10% of the nodes crash at 100 ms and
    recover at 400, two groups split from 50 to 250 ms, 5% of the sends
    drop, latencies grow 1.5x, node 7 is silent and node 11 delayed 40 ms."""
    return (FaultPlan("all_lanes").crash(list(range(5, n, 10)), at=100, recover=400)
            .partition((np.arange(n) % 2).astype(np.int32), start=50, end=250)
            .drop(50, start=0).inflate(1500, start=0)
            .silence([7], start=0).delay([11], 40, start=0))


def miner_policy(obs: dict) -> np.ndarray:
    """Release everything when behind, else withhold."""
    return np.where(obs["lag"] > 0, obs["n_withheld"], 0).astype(np.int32)


def _ethpow_case(config: str):
    def run(dev):
        net = BatchedEthPow(ETHPoWParameters(number_of_miners=ETH_MINERS,
                                             **ETH_CONFIGS.get(config, IDENTITY_AGENT)),
                            device=dev)
        return state_to_numpy(net.run_ms(replicate_ethpow(net.init_state(), 2), 600_000))
    return run


def _miner_env_case(dev):
    env = BatchedMinerEnv(ETHPoWParameters(**MINER_PARAMS), n_replicas=2,
                          decision_ms=MINER_DECISION_MS, device=dev)
    obs = env.reset()
    for _ in range(20):
        obs, _, _ = env.step(miner_policy(obs))
    return state_to_numpy(env.states)


def _faults_case(make, plan, ms, chunk):
    def run(dev):
        net, state = make(dev)
        fnet, states = net.with_faults(replicate_state(state, 2), FaultConfig(), plan)
        for _ in range(ms // chunk):
            states = fnet.run_ms_batched(states, chunk)
        return state_to_numpy(states)
    return run


def _tele_case(make, ms, chunk, clocks=None):
    """2 replicas run in chunks as an IDENTITY case; with `clocks` the
    batch starts on clocks (0, c): replica 1 advanced c ms first."""
    def run(dev):
        net, state = make(dev)
        states = replicate_state(state, 2)
        if clocks:
            ahead = net.run_ms_batched(states, clocks[1])
            states = map_state(lambda a, b: torch.stack([a[0], b[1]]), states, ahead)
        for _ in range(ms // chunk):
            states = net.run_ms_batched(states, chunk)
        return state_to_numpy(states)
    return run


def _fault_sweep_case(dev):
    """run_fault_sweep over PingPong at 64 nodes with a duplicated plan (two
    rows a plan): the out state and the records, as JSON bytes."""
    net, state = make_pingpong(64, device=dev)
    plan = all_lanes_plan(64)
    out, records = run_fault_sweep(net, state, [plan, None, plan], 300, replicas_per_plan=2,
                                   done_cdf_every=50)
    leaves = state_to_numpy(out)
    leaves["records"] = np.frombuffer(json.dumps(records).encode(), np.uint8)
    return leaves


def _library_loads() -> int:
    """nvcc builds and library loads this process has made."""
    return sum(lib.builds + lib.loads for lib in kernels.LIBRARIES)


def _search_case(dev):
    """A 2-generation ES campaign on the registry's 64-node Handel, 200 ms,
    population 4: its report (less the wall seconds and the per-process
    counters) as JSON bytes.  No library is built or loaded after the
    first generation: a leaf both sides give as True, and on the card a
    failure here."""
    driver = SearchDriver(SearchConfig(protocol="handel", sim_ms=200, generations=2,
                                       population=4, seed=0, optimizer="es",
                                       label="handel-es-identity"),
                          recorder=FlightRecorder(), device=dev)
    driver.run_generation()
    loads = _library_loads()
    report = driver.run()
    if _library_loads() != loads:
        raise AssertionError("search identity: a kernel library was built or loaded after "
                             "the first generation")
    report.pop("metrics")
    for row in report["history"]:
        row.pop("eval_s")
    return {"report": np.frombuffer(json.dumps(report, sort_keys=True).encode(), np.uint8),
            "no_load_after_first_generation": np.array([True])}


def _checkpoint_case(dev):
    """flagship_params(64) Handel x 2 saved at tick 100 through a
    CheckpointManager, loaded and run 100 more ticks: the resumed state,
    which must equal the uninterrupted 200-tick run on the same device."""
    net, state = make_handel(flagship_params(64), score_cache=True, device=dev)
    s0 = replicate_state(state, 2)
    s100 = net.run_ms_batched(s0, 100)
    straight = state_to_numpy(net.run_ms_batched(s100, 100))
    with tempfile.TemporaryDirectory() as ck:
        mgr = CheckpointManager(ck)
        mgr.save(s100, 100)
        loaded, step, _ = mgr.restore_latest(s0)
    if step != 100 or loaded.done_at.device.type != torch.device(dev).type:
        raise AssertionError(f"checkpoint identity: restored step {step} on "
                             f"{loaded.done_at.device}")
    resumed = state_to_numpy(net.run_ms_batched(loaded, 100))
    bad = _leaf_diff(straight, resumed)
    if bad:
        raise AssertionError(f"checkpoint identity on {dev}: resumed run differs in {bad[:10]}")
    return resumed


def _env_policy_case(dev):
    """optimize_env_policy on BatchedAttackEnv(n_replicas=4, decision_ms=200,
    horizon_ms=600, seed=0), 2 generations: best_vec and best_score."""
    env = BatchedAttackEnv(n_replicas=4, decision_ms=200, horizon_ms=600, seed=0, device=dev)
    opt = optimize_env_policy(env, generations=2, seed=0, recorder=FlightRecorder())
    return {"best_vec": opt.best_vec, "best_score": np.array([opt.best_score])}


IDENTITY_AGENT = dict(byz_class_name="ETHMinerAgent", byz_mining_ratio=0.45)
# cases that run their own way: case -> (run on a device -> numpy leaves, ms)
IDENTITY_RUNS = {
    "env_policy": (_env_policy_case, 600),
    "search_handel": (_search_case, 200),
    "ethpow_honest": (_ethpow_case("honest"), 600_000),
    "ethpow_selfish": (_ethpow_case("selfish"), 600_000),
    "ethpow_selfish2": (_ethpow_case("selfish2"), 600_000),
    "ethpow_agent": (_ethpow_case("agent"), 600_000),
    "miner_env": (_miner_env_case, 20 * MINER_DECISION_MS),
    "faults_pingpong": (_faults_case(lambda dev: make_pingpong(64, device=dev),
                                     all_lanes_plan(64), 300, 300), 300),
    "handel_silence": (_faults_case(
        lambda dev: make_handel(flagship_params(64), score_cache=True, device=dev),
        FaultPlan("silence_bloc").silence(list(range(51, 64)), start=0), 300, 100), 300),
    "pingpong_tele": (_tele_case(lambda dev: make_pingpong(64, telemetry=TELE_CFG, device=dev),
                                 300, 300), 300),
    "faults_pingpong_tele": (_faults_case(
        lambda dev: make_pingpong(64, telemetry=TELE_CFG, device=dev), all_lanes_plan(64),
        300, 300), 300),
    "fault_sweep_pingpong": (_fault_sweep_case, 300),
    "checkpoint_handel": (_checkpoint_case, 200),
    "handel_tele_clocks_0_7": (_tele_case(lambda dev: make_handel(
        flagship_params(64), score_cache=True, telemetry=TELE_CFG, device=dev),
        100, 100, clocks=(0, 7)), 100),
}


@torch.inference_mode()
def identity_state(case: str, dev: str) -> tuple:
    """One identity case on one device: 2 replicas run in chunks; (the
    worker's seconds, the state as numpy leaves)."""
    t0 = time.perf_counter()
    if case in IDENTITY_RUNS:
        leaves = IDENTITY_RUNS[case][0](dev)
        return time.perf_counter() - t0, leaves
    make, ms, chunk = IDENTITY[case]
    net, state = make(dev)
    states = replicate_state(state, 2)
    for _ in range(ms // chunk):
        states = net.run_ms_batched(states, chunk)
    return time.perf_counter() - t0, state_to_numpy(states)


def _one_thread() -> None:
    # the CPU side runs many small ops, which one intra-op thread runs
    # faster than a pool
    torch.set_num_threads(1)


def identity() -> None:
    """Each IDENTITY case gives identical state in every leaf on the CPU
    (plain versions) and on CUDA (kernels).  Both sides of every case run
    in worker processes, three on the CPU and six on the card, all
    started together (each side's host loop holds one core; the card
    serves the six in turn, and a case's CUDA side takes about twice its
    CPU side); every worker is joined or terminated when the phase ends.
    `ready_s` is when both sides of a case were in, `cpu_s` and `cuda_s`
    each side's own seconds."""
    ctx = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    with ctx.Pool(3, initializer=_one_thread) as cpu_pool, \
            ctx.Pool(6, initializer=_one_thread) as cuda_pool:
        # the cases that run their own way after the eleven longest
        cases = list(IDENTITY)[:11] + list(IDENTITY_RUNS) + list(IDENTITY)[11:]
        cpu = {case: cpu_pool.apply_async(identity_state, (case, "cpu")) for case in cases}
        cuda = {case: cuda_pool.apply_async(identity_state, (case, "cuda")) for case in cases}
        for case in cases:
            cuda_s, out = cuda[case].get()
            cpu_s, want = cpu[case].get()
            bad = _leaf_diff(want, out)
            if bad:
                raise AssertionError(f"identity {case}: CPU and CUDA differ in {bad[:10]}")
            ms = IDENTITY_RUNS[case][1] if case in IDENTITY_RUNS else IDENTITY[case][1]
            row = {"phase": "identity", "case": case, "replicas": 2, "ms": ms,
                   "leaves_equal": True, "ready_s": time.perf_counter() - t0,
                   "cpu_s": cpu_s, "cuda_s": cuda_s}
            if "x" in out:
                row.update({"nodes": int(out["x"].shape[-1]),
                            "done_nodes": int((out["done_at"] > 0).sum()),
                            "dropped": int(out["dropped"].sum()),
                            "overflow_live": out["ovf_valid"].sum(-1).tolist()})
            if isinstance(out.get("faults"), dict):
                row["dropped_by_fault"] = int(out["faults"]["dropped_by_fault"].sum())
                row["delayed_by_fault"] = int(out["faults"]["delayed_by_fault"].sum())
            if isinstance(out.get("tele"), dict):
                row["tele_ticks"] = out["tele"]["ticks"].tolist()
                row["tele_lat_sent"] = int(out["tele"]["lat_sent"].sum())
                row["time"] = out["time"].tolist()
            if "n_blocks" in out:
                row.update({"n_blocks": out["n_blocks"].tolist(),
                            "overflowed": out["overflowed"].tolist()})
            emit(row)
        for pool in (cpu_pool, cuda_pool):
            pool.close()
            pool.join()


def _quantiles(done: np.ndarray, down: np.ndarray) -> dict:
    live = done[~down]
    fin = live[live > 0]
    q = np.percentile(fin, [10, 50, 90]).tolist() if fin.size else [None] * 3
    return {"done_share": float(fin.size / max(1, live.size)),
            "done_at_p10": q[0], "done_at_p50": q[1], "done_at_p90": q[2]}


def drive(params, replicas: int, make=make_handel, ms: int = SIM_MS, profile: str = None) -> dict:
    """A lockstep path (Handel, GSF) as a user drives it: make(params),
    replicate_state, run_ms_batched in CHUNK_MS-ms chunks with
    stop_when_done for `ms` ms; returns its measurements.  With `profile`,
    the first LOCKSTEP_PROFILE_TICKS ticks of the chunk from tick
    PROFILE_FROM run in a torch.profiler window of that name; its ticks
    are left out of the wall time, which is the rest's scaled to the
    whole run."""
    torch.cuda.synchronize()
    t_build = time.perf_counter()
    net, state = make(params)
    states = replicate_state(state, replicas)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_build
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    wall, window = 0.0, None
    t0 = time.perf_counter()
    for c in range(ms // CHUNK_MS):
        if profile and c * CHUNK_MS == PROFILE_FROM:
            torch.cuda.synchronize()
            wall += time.perf_counter() - t0
            states, window = _profile_ticks(net, states, LOCKSTEP_PROFILE_TICKS, profile, True)
            t0 = time.perf_counter()
            states = net.run_ms_batched(states, CHUNK_MS - LOCKSTEP_PROFILE_TICKS, True)
        else:
            states = net.run_ms_batched(states, CHUNK_MS, True)
    torch.cuda.synchronize()
    wall += time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels.KERNELS}
    done = states.done_at.cpu().numpy()
    down = states.down.cpu().numpy()
    live_done = np.where(down, 1, done)
    # the lockstep loop stops before the tick after the last completion
    ticks = int(done.max()) + 1 if (live_done > 0).all() else ms
    if window is not None:
        wall *= ticks / (ticks - LOCKSTEP_PROFILE_TICKS)
        window["device_busy_share"] = window["device_ms_per_tick"] / (wall / ticks * 1e3)
    return {
        "nodes": params.node_count,
        "replicas": replicas,
        "build_s": build_s,
        "wall_s": wall,
        "sims_per_s": replicas / wall,
        "ticks": ticks,
        "ms_per_tick": wall / ticks * 1e3,
        "launches": launches,
        "launches_per_tick": {k: v / ticks for k, v in launches.items()},
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "displaced": states.proto["displaced"].cpu().tolist(),
        **_quantiles(done, down),
        "_all_live_done": bool((live_done > 0).all()),
        "_window": window,
        "_net": net,
        "_states": states,
    }


def flagship() -> dict:
    """The flagship Handel at 4096 nodes, R = FLAGSHIP_REPLICAS, SIM_MS
    ms, with its profile window inside the run.  Its final states stay in
    `_states` for the telemetry phase."""
    out = drive(flagship_params(4096), FLAGSHIP_REPLICAS, profile="profile")
    out["_done_at"] = out["_states"].done_at.cpu().numpy()  # attack_env's reference
    del out["_net"]
    window = out.pop("_window")
    out["_kernels_per_tick"] = window["kernels_per_tick"]
    if not out["_all_live_done"]:
        raise AssertionError(f"flagship: not every live node finished: {out}")
    for name in ("popcount_words", "popcount_binop", "cand_score"):
        if out["launches"][name] <= 0:
            raise AssertionError(f"flagship: {name} kernel never launched")
    emit({"phase": "flagship", **{k: v for k, v in out.items() if not k.startswith("_")}})
    emit(window)
    return out


def _differing_leaves(a, b, rows=slice(None)) -> list:
    """The leaves in which two batched states differ on the replicas
    `rows`, compared on the card; the side-cars are left out (a run may
    carry one the other does not)."""
    differ = []
    for name in a._fields:
        va, vb = getattr(a, name), getattr(b, name)
        if name in ("tele", "faults"):
            continue
        if isinstance(va, dict):
            differ += [f"proto.{k}" for k, v in va.items() if not torch.equal(v[rows], vb[k][rows])]
        elif isinstance(va, torch.Tensor) and not torch.equal(va[rows], vb[rows]):
            differ.append(name)
    return differ


def _tele_checks(tag: str, states) -> dict:
    """The telemetry side-car's checks on a final batched state, read once:
    the store invariant per replica with the exact census, the per-mtype
    drops against the store's, and the ring's done counts against the
    host-side CDF of done_at at each written slot's tick."""
    tele = {k: v.cpu().numpy() for k, v in states.tele._asdict().items()}
    pending = (states.msg_valid.sum((-2, -1)) + states.ovf_valid.sum(-1)).cpu().numpy()
    balance = tele["sent"].sum(-1) - (tele["delivered"].sum(-1) + tele["discarded"].sum(-1)
                                      + tele["dropped"].sum(-1) + pending)
    if balance.any():
        raise AssertionError(f"{tag}: sent != delivered + discarded + dropped + pending on "
                             f"{int((balance != 0).sum())} replicas")
    if not np.array_equal(tele["dropped"].sum(-1), states.dropped.cpu().numpy()):
        raise AssertionError(f"{tag}: per-mtype drops differ from the store's")
    # done_at's CDF at each slot's tick: the done ticks sorted, not-done
    # last, then a search per slot (on the card)
    done = states.done_at
    ranked = torch.where(done > 0, done, INT32_MAX).sort(-1).values
    cdf = torch.searchsorted(ranked, states.tele.snap_time.contiguous(), right=True)
    snap_t, snap_done = tele["snap_time"], tele["snap_done"]
    written = snap_t >= 0
    if not np.array_equal(np.where(written, snap_done, 0),
                          np.where(written, cdf.cpu().numpy(), 0)):
        raise AssertionError(f"{tag}: the ring's done counts differ from done_at's CDF")
    return {"snapshots_written": int(written.sum()),
            "sent": int(tele["sent"].sum()), "delivered": int(tele["delivered"].sum()),
            "discarded": int(tele["discarded"].sum()), "lat_sent": int(tele["lat_sent"].sum()),
            "lat_filtered": int(tele["lat_filtered"].sum()),
            "wheel_fill_hwm": int(tele["wheel_fill_hwm"].max()),
            "ovf_hwm": int(tele["ovf_hwm"].max()),
            "ticks_p10_p50_p90": _percentiles(tele["ticks"]),
            "jumps_total": int(tele["jumps"].sum()), "jumped_ms_total": int(tele["jumped_ms"].sum()),
            "_ticks": tele["ticks"]}


def telemetry(plain) -> dict:
    """The flagship with the telemetry side-car (TELE_CFG) on replicas
    0-3 of the flagship phase's seeds (R = TELE_REPLICAS), for exactly
    the flagship phase's executed ticks (`plain["ticks"]`: the plain
    batch's replicas 0-3 stepped until all 16 were done) and then the
    rest of the horizon with stop_when_done, which steps nothing more;
    tele_profile (ticks 100-109, with the per-tick stop test, as the
    flagship's window) inside the run.  Every non-tele leaf equals
    replicas 0-3 of the flagship phase's final states, the store
    invariant and the ring's CDF hold per replica, every node is done,
    the popcount family launches; ms and kernels a tick beside the plain
    flagship's."""
    ticks = SIM_MS if plain is None else plain["ticks"]
    torch.cuda.synchronize()
    t_build = time.perf_counter()
    net, state = make_handel(flagship_params(FLAGSHIP_NODES), telemetry=TELE_CFG)
    states = replicate_state(state, TELE_REPLICAS)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_build
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    states = net.run_ms_batched(states, PROFILE_FROM)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    states, window = _profile_ticks(net, states, LOCKSTEP_PROFILE_TICKS, "tele_profile", True)
    t0 = time.perf_counter()
    states = net.run_ms_batched(states, ticks - PROFILE_FROM - LOCKSTEP_PROFILE_TICKS)
    torch.cuda.synchronize()
    wall = (wall + time.perf_counter() - t0) * ticks / (ticks - LOCKSTEP_PROFILE_TICKS)
    launches = {k.name: k.launches for k in kernels.KERNELS}
    states = net.run_ms_batched(states, SIM_MS - ticks, True)
    window["device_busy_share"] = window["device_ms_per_tick"] / (wall / ticks * 1e3)
    checks = _tele_checks("telemetry", states)
    checks.pop("_ticks")
    differ = None if plain is None else _differing_leaves(
        states, map_state(lambda a: a[:TELE_REPLICAS], plain["_states"]))
    done = states.done_at.cpu().numpy()
    live_done = np.where(states.down.cpu().numpy(), 1, done)
    row = {"phase": "telemetry", "nodes": FLAGSHIP_NODES, "replicas": TELE_REPLICAS,
           "build_s": build_s, "wall_s": wall, "ticks": ticks, "ms_per_tick": wall / ticks * 1e3,
           "kernels_per_tick": window["kernels_per_tick"],
           "device_ms_per_tick": window["device_ms_per_tick"],
           "device_busy_share": window["device_busy_share"],
           "launches": launches, "launches_per_tick": {k: v / ticks for k, v in launches.items()},
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "plain_replicas": FLAGSHIP_REPLICAS,
           "plain_ms_per_tick": None if plain is None else plain["ms_per_tick"],
           "plain_kernels_per_tick": None if plain is None else plain["_kernels_per_tick"],
           "equal_plain": None if plain is None else not differ, **checks}
    emit(row)
    emit(window)
    if differ:
        raise AssertionError(f"telemetry: the instrumented flagship differs from plain in {differ}")
    if not (live_done > 0).all():
        raise AssertionError("telemetry: not every live node finished")
    if not checks["lat_sent"]:
        raise AssertionError("telemetry: no send counted")
    for name in ("popcount_words", "popcount_binop", "cand_score"):
        if launches[name] <= 0:
            raise AssertionError(f"telemetry: {name} kernel never launched")
    return row


def sweep_configs() -> list:
    """BASELINE config 3: Handel at SWEEP_NODES under default_params, the
    byzantineSuicide attack at each fraction of SWEEP_FRACTIONS (none at
    0%)."""
    return [SweepConfig("byzSuicide", dr, default_params(
        SWEEP_NODES, dead_ratio=dr, byzantine_suicide=dr > 0)) for dr in SWEEP_FRACTIONS]


def cities_config():
    """The allScenarios "111" corner at levelWaitTime 50: the CITIES builder
    with UniformSpeed and 20% Tor, NetworkLatencyByCityWJitter, 20% dead,
    a 100-ms desynchronized start."""
    return log_start_time_configs(SWEEP_NODES, dead=0.2, tor=0.2)[2]


def _row0_stats(states) -> dict:
    """run_sweep's BasicStats over row 0's live nodes."""
    live = ~states.down[0].cpu().numpy()
    d = states.done_at[0].cpu().numpy()[live]
    r = states.msg_received[0].cpu().numpy()[live]
    p = states.proto
    return {"done_at_min": int(d.min()), "done_at_avg": int(d.mean()),
            "done_at_max": int(d.max()), "msg_rcv_min": int(r.min()),
            "msg_rcv_avg": int(r.mean()), "msg_rcv_max": int(r.max()),
            "msg_filtered_avg": int(p["msg_filtered"][0].cpu().numpy()[live].mean()),
            "sigs_checked_avg": int(p["sigs_checked"][0].cpu().numpy()[live].mean())}


@contextlib.contextmanager
def _group_probe(window_phase=None):
    """Instrument BatchedNetwork.run_ms_batched while run_sweep drives its
    groups: each call's wall seconds, executed ticks, launches, peak
    memory, row 0's numbers and every row's completion.  With
    `window_phase`, a LOCKSTEP_PROFILE_TICKS torch.profiler window runs
    inside the call from tick PROFILE_FROM (its ticks left out of the
    wall time, which is scaled to the whole run), and the eligibility rows
    (byz, bl) of that tick are kept for the kernel timings.  Chunked calls
    give the state one call gives: the loop's stop test runs before every
    tick either way."""
    orig = BatchedNetwork.run_ms_batched
    calls, inside = [], []

    def run(net, states, ms, stop_when_done=False):
        if inside:
            return orig(net, states, ms, stop_when_done)
        inside.append(True)
        try:
            before = {k.name: k.launches for k in kernels.KERNELS}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            window = real = None
            t0 = time.perf_counter()
            if window_phase:
                states = orig(net, states, PROFILE_FROM, stop_when_done)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                real = [(a.cpu(), b.cpu()) for a, b in lowest_real_rows(net, states)]
                states, window = _profile_ticks(net, states, LOCKSTEP_PROFILE_TICKS,
                                                window_phase, stop_when_done)
                t0 = time.perf_counter()
                states = orig(net, states, ms - PROFILE_FROM - LOCKSTEP_PROFILE_TICKS,
                              stop_when_done)
            else:
                wall = 0.0
                states = orig(net, states, ms, stop_when_done)
            torch.cuda.synchronize()
            wall += time.perf_counter() - t0
            done = states.done_at.cpu().numpy()
            down = states.down.cpu().numpy()
            undone = ((done == 0) & ~down).sum(-1).tolist()
            all_done = not any(undone)
            # the lockstep loop stops before the tick after the last completion
            ticks = int(done.max()) + 1 if stop_when_done and all_done else ms
            if window is not None:
                wall *= ticks / (ticks - LOCKSTEP_PROFILE_TICKS)
                window["device_busy_share"] = window["device_ms_per_tick"] / (wall / ticks * 1e3)
            p = states.proto
            calls.append({
                "replicas": int(done.shape[0]), "ticks": ticks, "wall_s": wall,
                "ms_per_tick": wall / ticks * 1e3,
                "launches": {k.name: k.launches - before[k.name] for k in kernels.KERNELS},
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "undone_by_row": undone, "dropped": int(states.dropped.sum()),
                "displaced": int(p["displaced"].sum()),
                "row0": _row0_stats(states),
                "row0_sums": {"done": int((done[0] > 0).sum()),
                              "msg_received": int(states.msg_received[0].to(torch.int64).sum()),
                              "msg_filtered": int(p["msg_filtered"][0].to(torch.int64).sum()),
                              "sigs_checked": int(p["sigs_checked"][0].to(torch.int64).sum())},
                "_window": window, "_real": real,
            })
            return states
        finally:
            inside.pop()

    BatchedNetwork.run_ms_batched = run
    try:
        yield calls
    finally:
        BatchedNetwork.run_ms_batched = orig


@torch.inference_mode()
def sweep_point(task: tuple) -> dict:
    """One group of a sweep in a worker process, as a user runs it:
    run_sweep over the one config (run_sweep([config], seed0)) with the
    launch counts zeroed just before and read just after; ("sweep", i) is
    point i of sweep_configs() at seed0 1000 * i, the seeds its rows have
    in the whole list, ("cities", 0) the cities configuration."""
    _one_thread()
    what, i = task
    if what == "sweep":
        cfg, ms, stop = sweep_configs()[i], SWEEP_MS, True
        window = "sweep_profile" if i == SWEEP_PROFILE_POINT else None
    else:
        cfg, ms, stop, window = cities_config(), CITIES_MS, False, None
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with _group_probe(window) as calls:
        stats = run_sweep([cfg], replicas=SWEEP_REPLICAS, sim_ms=ms, seed0=1000 * i,
                          stop_when_done=stop)
    (call,) = calls
    return {"what": what, "point": i, "value": cfg.value, "stats": stats[0].row(),
            "seconds": time.perf_counter() - t0,
            "sweep_launches": {k.name: k.launches for k in kernels.KERNELS}, **call}


@contextlib.contextmanager
def _run_probe():
    """Record every BatchedNetwork.run_ms_batched call while the search
    drives run_fault_sweep: its replicas, ms, wall seconds, loop
    iterations (the event-driven loop's count, else one a tick), ms an
    iteration and launches of every form."""
    orig = BatchedNetwork.run_ms_batched
    calls = []

    def run(net, states, ms, stop_when_done=False):
        before = {k.name: k.launches for k in kernels.KERNELS}
        net.jump_stats = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(net, states, ms, stop_when_done)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        its = net.jump_stats["iterations"] if net.jump_stats else ms
        calls.append({"replicas": int(states.done_at.shape[0]), "ms": ms, "wall_s": wall,
                      "iterations": its, "ms_per_iteration": wall / its * 1e3,
                      "launches": {k.name: k.launches - before[k.name] for k in kernels.KERNELS}})
        return out

    BatchedNetwork.run_ms_batched = run
    try:
        yield calls
    finally:
        BatchedNetwork.run_ms_batched = orig


def _replay_pin(name: str, tag: str) -> dict:
    """verify_regression of a checked-in pin on CUDA: the exact pinned
    score, and the re-scored static baselines equal to the pinned ones."""
    doc = load_regression(REGRESSIONS_DIR / SEARCH_PINS[name])
    t0 = time.perf_counter()
    with _run_probe() as calls:
        out = verify_regression(doc)
    wall = time.perf_counter() - t0
    if out["objective_value"] != doc["objective_value"]:
        raise AssertionError(f"{tag}: replayed {out['objective_value']}, pinned "
                             f"{doc['objective_value']}")
    if out["baseline_scores"] != doc["baseline"]["scores"]:
        raise AssertionError(f"{tag}: baselines {out['baseline_scores']}, pinned "
                             f"{doc['baseline']['scores']}")
    launches = {k.name: sum(c["launches"][k.name] for c in calls) for k in kernels.KERNELS}
    ticks = sum(c["iterations"] for c in calls)
    return {"phase": tag, "protocol": doc["protocol"], "sim_ms": doc["sim_ms"],
            "objective_value": out["objective_value"], "plan_digest": out["plan_digest"],
            "baseline_scores": out["baseline_scores"], "wall_s": wall, "runs": calls,
            "iterations": ticks,
            "ms_per_iteration": sum(c["wall_s"] for c in calls) / ticks * 1e3,
            "launches": launches,
            "launches_per_iteration": {k: v / ticks for k, v in launches.items()}}


@torch.inference_mode()
def search_campaign() -> dict:
    """The JAX package's reference p2pflood campaign (SEARCH_CAMPAIGN) on
    CUDA, interrupted: driver 1 runs generation 0 and is dropped, driver
    2 resumes from the same checkpoint directory at generation 1 and runs
    to 3.  Its config digest, champion and best score a generation must
    be the JAX package's (SEARCH_DIGEST, SEARCH_CHAMPION,
    SEARCH_GEN_SCORES), no kernel library may be built or loaded after
    the first generation, and the pin replays exactly."""
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as ck, _run_probe() as calls:
        cfg = SearchConfig(**SEARCH_CAMPAIGN, checkpoint_dir=ck)
        first = SearchDriver(cfg, recorder=FlightRecorder())
        first.run_generation()
        loads = _library_loads()
        del first
        rec = FlightRecorder()
        driver = SearchDriver(cfg, recorder=rec)
        resumed_at = driver.generation
        report = driver.run()
        loads_after = _library_loads()
    wall = time.perf_counter() - t0
    champ = report["champion"]
    gens = []
    for row, call in zip(report["history"], calls):
        gens.append({"gen": row["gen"], "eval_s": row["eval_s"], "evals": row["evals"],
                     "replicas": call["replicas"], "iterations": call["iterations"],
                     "ms_per_iteration": call["ms_per_iteration"],
                     "launches": call["launches"], "best_gen_score": row["best_gen_score"],
                     "champion_score": row["champion_score"]})
    eval_s = sum(row["eval_s"] for row in report["history"])
    evals = sum(row["evals"] * row["replicas_per_plan"] for row in report["history"])
    out = {"phase": "search_campaign", **SEARCH_CAMPAIGN, "wall_s": wall,
           "resumed_at": resumed_at, "config_digest": report["config_digest"],
           "champion": {k: champ[k] for k in ("score", "plan_digest", "seed0", "generation",
                                              "availability", "vec")},
           "generations": gens, "evals": evals, "eval_s": eval_s, "evals_per_s": evals / eval_s,
           "frontier": report["frontier"],
           "events": [e["kind"] for e in rec.events()],
           "library_loads_after_first_generation": loads_after - loads,
           "launches": {k.name: sum(g["launches"][k.name] for g in gens)
                        for k in kernels.KERNELS}}
    out["replay"] = _replay_pin("p2pflood", "search_replay_p2pflood")
    return out


@torch.inference_mode()
def search_handel_replay() -> dict:
    """The JAX package's Handel pin replayed on CUDA: score 3000.0, the
    pinned baselines, the popcount family launched."""
    kernels.reset_launch_counts()
    return _replay_pin("handel", "search_replay_handel")


def pool_task(task: tuple) -> dict:
    """One task of the sweep phase's pool: a sweep group, the cities run,
    or one of the search phase's two tasks."""
    if task[0] == "search":
        _one_thread()
        return {"what": "search", "task": task[1],
                **(search_campaign() if task[1] == "campaign" else search_handel_replay())}
    return sweep_point(task)


def sweeps(points: bool, cities: bool, search: bool = False) -> dict:
    """The `sweep`, `cities` and `search` phases in one pool of SWEEP_POOL
    worker processes: each group of BASELINE config 3's sweep (one per
    Byzantine fraction: a fraction changes the threshold, a traced
    parameter, so run_sweep runs six groups of SWEEP_REPLICAS rows) and
    the cities run hold one core each on the host, and the card serves
    them in turn; the search's two tasks (the reference campaign with its
    pin's replay, and the Handel pin's replay) come last and take the
    slots that the 0% group and the cities run free.  Every worker is
    joined or terminated when the phase ends."""
    tasks = ([("sweep", i) for i in reversed(range(len(SWEEP_FRACTIONS)))] if points else [])
    tasks += [("cities", 0)] if cities else []
    # the Handel replay, the longer task, takes the first slot that frees
    tasks += [("search", "handel"), ("search", "campaign")] if search else []
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(min(SWEEP_POOL, len(tasks))) as pool:
        outs = pool.map(pool_task, tasks, chunksize=1)
        pool.close()
        pool.join()
    elapsed = time.perf_counter() - t0
    res = {}
    if points:
        res["sweep"] = _sweep_checks([o for o in outs if o["what"] == "sweep"], elapsed)
    if cities:
        res["cities"] = _cities_checks([o for o in outs if o["what"] == "cities"][0])
    if search:
        res["search"] = _search_checks({o["task"]: o for o in outs if o["what"] == "search"})
    return res


def _search_checks(outs: dict) -> dict:
    camp, handel = outs["campaign"], outs["handel"]
    replay = camp.pop("replay")
    for row in (camp, replay, handel):
        emit(row)
    if camp["config_digest"] != SEARCH_DIGEST:
        raise AssertionError(f"search: config digest {camp['config_digest']}, the JAX "
                             f"package's {SEARCH_DIGEST}")
    if camp["resumed_at"] != 1:
        raise AssertionError(f"search: the second driver resumed at {camp['resumed_at']}")
    got = {k: camp["champion"][k] for k in SEARCH_CHAMPION}
    if got != SEARCH_CHAMPION:
        raise AssertionError(f"search: champion {got}, the JAX package's {SEARCH_CHAMPION}")
    scores = [g["best_gen_score"] for g in camp["generations"]]
    if scores != SEARCH_GEN_SCORES:
        raise AssertionError(f"search: best scores {scores}, the JAX package's "
                             f"{SEARCH_GEN_SCORES}")
    if camp["library_loads_after_first_generation"]:
        raise AssertionError("search: a kernel library was built or loaded after the first "
                             "generation")
    want_events = ["search-resume"] + ["search-generation", "checkpoint"] * 2 + [
        "search-complete"]
    if camp["events"] != want_events:
        raise AssertionError(f"search: the resumed driver recorded {camp['events']}")
    for name in ("popcount_words", "popcount_binop", "cand_score"):
        if handel["launches"][name] <= 0:
            raise AssertionError(f"search: {name} kernel never launched on the Handel replay")
    launches = {k: camp["launches"][k] + replay["launches"][k] + handel["launches"][k]
                for k in handel["launches"]}
    row = {"phase": "search", "launches": launches,
           "campaign_s": camp["wall_s"], "campaign_evals_per_s": camp["evals_per_s"],
           "handel_replay_s": handel["wall_s"],
           "handel_ms_per_tick": handel["ms_per_iteration"],
           "handel_launches_per_tick": handel["launches_per_iteration"]}
    emit(row)
    return row


def _sweep_checks(outs: list, elapsed: float) -> dict:
    outs = sorted(outs, key=lambda o: o["point"])
    csv = CSVFormatter("byzSuicide", CSV_FIELDS)
    for o in outs:
        csv.add({"id": "byzSuicide", "nodes": SWEEP_NODES, "value": o["value"], **o["stats"]})
        window = o.pop("_window")
        real = o.pop("_real")
        if window is not None:
            emit(window)
            o["kernels_per_tick"] = window["kernels_per_tick"]
            o["device_ms_per_tick"] = window["device_ms_per_tick"]
            o["device_busy_share"] = window["device_busy_share"]
            o["real_rows"] = real
        emit({"phase": "sweep_group", **{k: v for k, v in o.items() if k != "real_rows"}})
    emit({"phase": "sweep_csv", "csv": csv.to_string()})
    launches = {k.name: sum(o["sweep_launches"][k.name] for o in outs) for k in kernels.KERNELS}
    run_s = max(o["wall_s"] for o in outs)
    row = {"phase": "sweep", "nodes": SWEEP_NODES, "replicas": SWEEP_REPLICAS,
           "points": len(outs), "rows": SWEEP_REPLICAS * len(outs), "elapsed_s": elapsed,
           "run_s": run_s, "sims_per_s": SWEEP_REPLICAS * len(outs) / run_s,
           "ticks": {str(o["value"]): o["ticks"] for o in outs},
           "ms_per_tick": {str(o["value"]): o["ms_per_tick"] for o in outs},
           "max_memory_allocated": max(o["max_memory_allocated"] for o in outs),
           "dropped": sum(o["dropped"] for o in outs),
           "displaced": sum(o["displaced"] for o in outs), "launches": launches,
           "undone_by_row": {str(o["value"]): o["undone_by_row"] for o in outs},
           "row0": {str(o["value"]): {"ticks": o["ticks"], **o["row0"]} for o in outs}}
    emit(row)
    for o in outs:
        want_undone = SWEEP_UNDONE.get(o["value"], [0] * SWEEP_REPLICAS)
        if o["undone_by_row"] != want_undone:
            raise AssertionError(f"sweep {o['value']}: live nodes undone by row "
                                 f"{o['undone_by_row']}, the JAX package's {want_undone}")
        if not any(want_undone) and o["stats"]["done_at_min"] <= 0:
            raise AssertionError(f"sweep {o['value']}: not every live node finished")
        if o["dropped"]:
            raise AssertionError(f"sweep {o['value']}: {o['dropped']} messages dropped")
        names = ("popcount_words", "popcount_binop", "cand_score") + (
            ("lowest_set_bit_andnot",) if o["value"] > 0 else ())
        for name in names:
            if o["sweep_launches"][name] <= 0:
                raise AssertionError(f"sweep {o['value']}: {name} kernel never launched")
        want = SWEEP_R0.get(o["value"])
        if want is not None:
            _check_replica0(f"sweep {o['value']}", {"ticks": o["ticks"], **o["row0"]}, want)
    by = {o["value"]: o["stats"] for o in outs}
    if len(by) == len(SWEEP_FRACTIONS) and not by[SWEEP_FRACTIONS[-1]]["done_at_avg"] \
            > by[0.0]["done_at_avg"]:
        raise AssertionError("sweep: the 25% point's done_at_avg is not above the 0% point's")
    row["_real"] = next(o["real_rows"] for o in outs if "real_rows" in o)
    return row


def _cities_checks(o: dict) -> dict:
    o.pop("_window")
    o.pop("_real")
    row = {"phase": "cities", "nodes": SWEEP_NODES, **o}
    emit(row)
    if o["dropped"]:
        raise AssertionError(f"cities: {o['dropped']} messages dropped")
    for name in ("popcount_words", "popcount_binop", "cand_score"):
        if o["sweep_launches"][name] <= 0:
            raise AssertionError(f"cities: {name} kernel never launched")
    if CITIES_R0 is not None:
        _check_replica0("cities", o["row0_sums"], CITIES_R0)
    row["launches"] = o["sweep_launches"]
    return row


def gsf() -> dict:
    """GSF at 2048 nodes (BASELINE config 2, the defaults of gsf.py),
    R = 32, 1000 ms in 20-ms chunks with stop_when_done, with gsf_profile
    inside the run."""
    params = GSFSignatureParameters(node_count=GSF_NODES)
    out = drive(params, GSF_REPLICAS, make=make_gsf, profile="gsf_profile")
    del out["_net"], out["_states"]
    window = out.pop("_window")
    if not out["_all_live_done"]:
        raise AssertionError(f"gsf: not every node finished: {out}")
    for name in ("popcount_words", "popcount_binop", "cand_score", "lowest_set_bit"):
        if out["launches"][name] <= 0:
            raise AssertionError(f"gsf: {name} kernel never launched")
    emit({"phase": "gsf", "threshold": params.threshold,
          **{k: v for k, v in out.items() if not k.startswith("_")}})
    emit(window)
    return out


def p2p_replica0(states) -> dict:
    """P2PHandel's replica-0 counters (P2P_R0)."""
    p = states.proto
    return {"msg_received": int(states.msg_received[0].sum()),
            "msg_sent": int(states.msg_sent[0].sum()),
            "done": int((states.done_at[0] > 0).sum()),
            **{k: int(p[k][0].to(torch.int64).sum()) for k in (
                "verified", "ver_card", "ver_sig", "peers_state", "ver_done_t", "last_check")}}


def durable_plans(n: int) -> list:
    """The durable sweep's plans: the control row and DURABLE_CRASH's
    share of the nodes (the first ones) down from its first ms, back at
    its second."""
    share, at, back = DURABLE_CRASH
    crash = FaultPlan(f"crash{int(share * 100)}@{at}").crash(
        list(range(int(n * share))), at=at, recover=back)
    return [None, crash]


def durable_replica0(states) -> dict:
    """Row 0 (the control) of the durable sweep in the numbers the JAX
    package's seed-0 run gives (DURABLE_R0), with a digest of every leaf
    of the row (checkpoint order, the JAX package's dtypes)."""
    t = states.tele
    h = hashlib.blake2b(digest_size=16)
    for key, leaf in _host_leaves(states):
        h.update(key.encode())
        h.update(np.ascontiguousarray(leaf[0]).tobytes())
    return {"digest": h.hexdigest(), "done": int((states.done_at[0] > 0).sum()),
            "done_at_sum": int(states.done_at[0].to(torch.int64).sum()),
            "msg_received": int(states.msg_received[0].to(torch.int64).sum()),
            "msg_sent": int(states.msg_sent[0].to(torch.int64).sum()),
            "sigs_checked": int(states.proto["sigs_checked"][0].to(torch.int64).sum()),
            "tele_sent": t.sent[0].tolist(), "tele_delivered": t.delivered[0].tolist(),
            "ticks": int(t.ticks[0]), "time": int(states.time[0])}


@contextlib.contextmanager
def _durable_probe():
    """Record this process's checkpoint saves (seconds, bytes on disk),
    restores (seconds) and supervised runs' provenance."""
    io = {"saves": [], "restores": [], "provenance": []}
    save, restore, run = (CheckpointManager.save, CheckpointManager.restore_latest,
                          Supervisor.run)

    def timed_save(mgr, state, step, meta=None):
        t0 = time.perf_counter()
        out = save(mgr, state, step, meta)
        io["saves"].append({"step": step, "seconds": time.perf_counter() - t0,
                            "bytes": os.path.getsize(mgr.path_for(step))})
        return out

    def timed_restore(mgr, template):
        t0 = time.perf_counter()
        out = restore(mgr, template)
        io["restores"].append({"step": None if out is None else out[1],
                               "seconds": time.perf_counter() - t0})
        return out

    def kept_run(sup):
        report = run(sup)
        io["provenance"].append(report.provenance)
        return report

    CheckpointManager.save, CheckpointManager.restore_latest = timed_save, timed_restore
    Supervisor.run = kept_run
    try:
        yield io
    finally:
        CheckpointManager.save, CheckpointManager.restore_latest = save, restore
        Supervisor.run = run


@torch.inference_mode()
def durable_child(role: str, ck: str) -> int:
    """One process of the durable phase: the flagship with TELE_CFG
    through run_fault_sweep over durable_plans, DURABLE_MS, as a user
    runs it.  `reference`: straight, no checkpoint directory, no
    recorder.  `victim`: resumable in `ck` (DURABLE_CHUNK_MS chunks,
    watchdog armed), a tail-safe FlightRecorder JSONL beside the
    checkpoints, a TimeSeriesStore and an InvariantSentinel, and a
    heartbeat that SIGKILLs the process after chunk DURABLE_KILL_AFTER.
    `resume`: the victim's arguments again, then the same sweep at twice
    the chunk size, which must refuse to resume.  Saves the final state
    to ck/final (engine.checkpoint's format) and prints its numbers as one
    JSON line."""
    _one_thread()
    os.makedirs(ck, exist_ok=True)
    t_build = time.perf_counter()
    net, state = make_handel(flagship_params(FLAGSHIP_NODES), telemetry=TELE_CFG)
    plans = durable_plans(FLAGSHIP_NODES)
    torch.cuda.synchronize()
    out = {"phase": f"durable_{role}", "nodes": FLAGSHIP_NODES, "replicas": len(plans),
           "build_s": time.perf_counter() - t_build}
    kw, rec, store, sentinel = {}, None, None, None
    if role != "reference":
        rec = FlightRecorder(path=os.path.join(ck, LIVE_BASENAME))
        store, sentinel = TimeSeriesStore(), InvariantSentinel(net=net, recorder=rec)
        ctx = None
        if not CheckpointManager(ck).steps():
            # a fresh run: this is its entry point; a resume adopts the
            # run_id from the checkpoint manifest instead
            ctx = mint_context("durable")
            rec.record("admission", ctx, protocol="handel", nodes=FLAGSHIP_NODES,
                       sim_ms=DURABLE_MS, chunk_ms=DURABLE_CHUNK_MS, plans=len(plans))

        def heartbeat(i: int, dt: float) -> None:
            if role == "victim" and i >= DURABLE_KILL_AFTER:
                rec.record("kill", ctx, after_chunk=i, signal="SIGKILL")
                os.kill(os.getpid(), signal.SIGKILL)

        kw = dict(checkpoint_dir=ck, chunk_ms=DURABLE_CHUNK_MS, supervisor_kw=dict(
            recorder=rec, timeseries=store, sentinel=sentinel, heartbeat=heartbeat, ctx=ctx,
            watchdog=DURABLE_WATCHDOG))
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _durable_probe() as io:
        states, records = run_fault_sweep(net, state, plans, DURABLE_MS, **kw)
        torch.cuda.synchronize()
        out["wall_s"] = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels.KERNELS}
        if role == "resume":
            # another chunk size on the same directory: refused before any chunk
            ran = []
            t1 = time.perf_counter()
            try:
                run_fault_sweep(net, state, plans, DURABLE_MS, checkpoint_dir=ck,
                                chunk_ms=2 * DURABLE_CHUNK_MS,
                                supervisor_kw=dict(recorder=FlightRecorder(),
                                                   heartbeat=lambda i, dt: ran.append(i)))
                refused = None
            except ResumeMismatchError as e:
                refused = str(e)[:200]
            out["mismatch"] = {"refused": refused, "chunks_run": len(ran),
                               "seconds": time.perf_counter() - t1}
    if io["provenance"]:
        prov = io["provenance"][0]
        chunks = prov["chunk_time_hist"]["count"]
        out.update({"ticks": chunks * DURABLE_CHUNK_MS,
                    "run_s": prov["chunk_time_hist"]["sum_s"],
                    "resumed_from_step": prov["resumed_from_step"], "chunks_run": chunks,
                    "run_id": prov["run_id"], "checkpoints": prov["checkpoints"],
                    "platform": prov["platform"], "degraded": prov["degraded"],
                    "chunk_time_hist": prov["chunk_time_hist"]})
    else:
        out.update({"ticks": DURABLE_MS, "run_s": out["wall_s"]})
    ticks = out["ticks"]
    f = states.faults
    out.update({
        "ms_per_tick": out["run_s"] / ticks * 1e3,
        "launches": launches, "launches_per_tick": {k: v / ticks for k, v in launches.items()},
        "nvcc_builds": sum(lib.builds for lib in kernels.LIBRARIES),
        "library_loads": sum(lib.loads for lib in kernels.LIBRARIES),
        "saves": io["saves"], "restores": io["restores"],
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "replica0": durable_replica0(states), "records": records,
        "crash_faults": {"dropped": int(f.dropped_by_fault[1].sum()),
                         "delayed": int(f.delayed_by_fault[1].sum())},
    })
    if store is not None:
        out["timeseries_chunk_seconds"] = store.count("supervisor.chunk_seconds")
        out["sentinel_violations"] = sentinel.violations
        out["sentinel_entry"] = sentinel.capacity_table.get(f"handel@{FLAGSHIP_NODES}")
    t1 = time.perf_counter()
    save_state(states, os.path.join(ck, "final"))
    out["final_save_s"] = time.perf_counter() - t1
    print(json.dumps(out), flush=True)
    return 0


class _DurableChain:
    """The durable phase's three child processes, one after another, on a
    thread of the main process, so they run beside the main process's
    other phases; `stop` kills a child that is still running."""

    def __init__(self):
        self.proc = None
        self.result = self.error = None
        self.seconds = None
        self.t0 = None
        self.thread = threading.Thread(target=self._run, name="durable", daemon=True)

    def start(self) -> "_DurableChain":
        atexit.register(self.stop)
        self.t0 = time.perf_counter()
        self.thread.start()
        return self

    def stop(self) -> None:
        proc = self.proc
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()

    def child(self, role: str, ck: str) -> tuple:
        """-> (returncode, its JSON line or None, the end of its stderr,
        seconds)."""
        t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--durable-child", role, ck],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            stdout, stderr = self.proc.communicate(timeout=DURABLE_CHILD_TIMEOUT)
        except subprocess.TimeoutExpired:
            self.stop()
            raise AssertionError(f"durable: the {role} run exceeded "
                                 f"{DURABLE_CHILD_TIMEOUT} s") from None
        row = None
        for line in stdout.splitlines():
            if line.startswith("{"):
                row = json.loads(line)
        return self.proc.returncode, row, stderr[-4000:], time.perf_counter() - t0

    def _run(self) -> None:
        try:
            self.result = durable(self)
        except BaseException as e:  # noqa: BLE001 — re-raised by join
            self.error = e
        self.seconds = time.perf_counter() - self.t0

    def join(self) -> dict:
        self.thread.join()
        if self.error is not None:
            raise self.error
        return self.result


def _saved_diff(a: str, b: str) -> list:
    """The leaves of two saved states whose shape, dtype or bytes differ."""
    with np.load(a, allow_pickle=False) as x, np.load(b, allow_pickle=False) as y:
        keys = sorted((set(x.files) | set(y.files)) - {"__manifest__"})
        return [k for k in keys if k not in x.files or k not in y.files
                or x[k].shape != y[k].shape or x[k].dtype != y[k].dtype
                or x[k].tobytes() != y[k].tobytes()]


def durable(chain: _DurableChain) -> dict:
    """The durable phase (scripts/durable_smoke.py's proof on the
    flagship): the reference child, the victim (which must die by
    SIGKILL after chunk DURABLE_KILL_AFTER), then the resume on the
    victim's directory.  Checks: the resume resumed from step
    DURABLE_KILL_AFTER and ran the remaining chunks; its final state
    equals the reference's in every leaf (tele and faults included) and
    its records the reference's; row 0 equals the JAX package's
    (DURABLE_R0); the crash row counted faults; the recorder tells one
    story under one run_id (admission, every chunk's chunk-end across
    both processes with tick counters, the checkpoints, the kill, the
    resume, run-complete); the restored time series holds every chunk's
    seconds; the sentinel raised nothing against the table's
    handel@4096 entry; another chunk size was refused before any chunk;
    the resume ran nvcc zero times and launched the popcount family."""
    n_chunks = DURABLE_MS // DURABLE_CHUNK_MS
    with tempfile.TemporaryDirectory(prefix="durable-") as d:
        ref_dir, run_dir = os.path.join(d, "ref"), os.path.join(d, "run")
        rc, ref, err, ref_s = chain.child("reference", ref_dir)
        if rc != 0 or ref is None:
            raise AssertionError(f"durable: the reference run failed (rc={rc}):\n{err}")
        rc, _, err, victim_s = chain.child("victim", run_dir)
        if rc != -signal.SIGKILL:
            raise AssertionError(f"durable: the victim should die by SIGKILL, rc={rc}:\n{err}")
        rc, res, err, resume_s = chain.child("resume", run_dir)
        if rc != 0 or res is None:
            raise AssertionError(f"durable: the resume run failed (rc={rc}):\n{err}")
        diverged = _saved_diff(os.path.join(ref_dir, "final"), os.path.join(run_dir, "final"))
        events = read_events(os.path.join(run_dir, LIVE_BASENAME))
    first_resume = next(i for i, e in enumerate(events) if e["kind"] == "resume") \
        if any(e["kind"] == "resume" for e in events) else len(events)
    victim_ends = [e for e in events[:first_resume] if e["kind"] == "chunk-end"]
    victim_ticks = len(victim_ends) * DURABLE_CHUNK_MS
    victim_run_s = sum(e["seconds"] for e in victim_ends)
    victim = {"phase": "durable_victim", "seconds": victim_s, "ticks": victim_ticks,
              "run_s": victim_run_s, "ms_per_tick": victim_run_s / max(1, victim_ticks) * 1e3,
              "chunk_seconds": [e["seconds"] for e in victim_ends],
              "events": [e["kind"] for e in events[:first_resume]]}
    ref["seconds"], res["seconds"] = ref_s, resume_s
    emit(ref)
    emit(victim)
    emit(res)
    pop = ("popcount_words", "popcount_binop", "cand_score")
    run_ids = sorted({e["run_id"] for e in events if e.get("run_id")})
    kinds = {e["kind"] for e in events}
    ends = sorted({e.get("chunk_seq") for e in events if e["kind"] == "chunk-end"})
    row = {"phase": "durable", "nodes": FLAGSHIP_NODES, "replicas": res["replicas"],
           "ms": DURABLE_MS, "chunk_ms": DURABLE_CHUNK_MS,
           "chain_s": time.perf_counter() - chain.t0,
           "seconds": {"reference": ref_s, "victim": victim_s, "resume": resume_s},
           "ms_per_tick": {"reference": ref["ms_per_tick"], "victim": victim["ms_per_tick"],
                           "resume": res["ms_per_tick"]},
           "launches_per_tick": {"reference": {k: ref["launches_per_tick"][k] for k in pop},
                                 "resume": {k: res["launches_per_tick"][k] for k in pop}},
           "checkpoint_s": [s["seconds"] for s in res["saves"]],
           "checkpoint_bytes": [s["bytes"] for s in res["saves"]],
           "restore_s": res["restores"][0]["seconds"],
           "restored_step": res["restores"][0]["step"],
           "chunk_time_hist": res["chunk_time_hist"],
           "resumed_from_step": res["resumed_from_step"], "chunks_run": res["chunks_run"],
           "leaves_diverged": diverged, "records_equal": res["records"] == ref["records"],
           "run_ids": run_ids, "kinds": sorted(kinds), "chunk_ends": ends,
           "timeseries_chunk_seconds": res["timeseries_chunk_seconds"],
           "sentinel_violations": res["sentinel_violations"],
           "sentinel_entry": res["sentinel_entry"], "mismatch": res["mismatch"],
           "resume_nvcc_builds": res["nvcc_builds"], "crash_faults": res["crash_faults"],
           "replica0": res["replica0"], "launches": res["launches"]}
    emit(row)
    if row["resumed_from_step"] != DURABLE_KILL_AFTER or \
            row["chunks_run"] != n_chunks - DURABLE_KILL_AFTER:
        raise AssertionError(f"durable: resumed from {row['resumed_from_step']} and ran "
                             f"{row['chunks_run']} chunks")
    if diverged:
        raise AssertionError(f"durable: kill-and-resume diverged on leaves {diverged[:20]}")
    if not row["records_equal"]:
        raise AssertionError(f"durable: records {res['records']}, the reference's "
                             f"{ref['records']}")
    for tag, got in (("reference", ref["replica0"]), ("resume", res["replica0"])):
        if got != DURABLE_R0:
            raise AssertionError(f"durable: {tag} row 0 gives {got}, the JAX package "
                                 f"{DURABLE_R0}")
    if not (row["crash_faults"]["dropped"] and ref["crash_faults"]["dropped"]):
        raise AssertionError(f"durable: the crash row counted no fault: {row['crash_faults']}")
    if len(run_ids) != 1 or run_ids[0] != res["run_id"]:
        raise AssertionError(f"durable: the recorder tells of run ids {run_ids}, the resume "
                             f"ran {res['run_id']}")
    need = {"admission", "chunk-start", "chunk-end", "checkpoint", "kill", "resume",
            "run-complete"}
    if not need <= kinds:
        raise AssertionError(f"durable: the recorder lacks {sorted(need - kinds)}")
    if ends != list(range(n_chunks)) or not all("ticks" in e for e in events
                                                if e["kind"] == "chunk-end"):
        raise AssertionError(f"durable: chunk-end events cover {ends} or lack tick counters")
    if victim["events"].count("checkpoint") != DURABLE_KILL_AFTER:
        raise AssertionError(f"durable: the victim wrote {victim['events'].count('checkpoint')} "
                             "checkpoints")
    if row["timeseries_chunk_seconds"] != n_chunks:
        raise AssertionError(f"durable: the restored time series holds "
                             f"{row['timeseries_chunk_seconds']} chunk samples")
    if row["sentinel_violations"] or row["sentinel_entry"] is None:
        raise AssertionError(f"durable: sentinel {row['sentinel_violations']} against "
                             f"{row['sentinel_entry']}")
    if row["mismatch"]["refused"] is None or row["mismatch"]["chunks_run"]:
        raise AssertionError(f"durable: a changed chunk size was not refused: {row['mismatch']}")
    if row["resume_nvcc_builds"]:
        raise AssertionError(f"durable: the resume ran nvcc {row['resume_nvcc_builds']} times")
    if res["platform"] != "gpu" or res["degraded"]:
        raise AssertionError(f"durable: the resume ran on {res['platform']}, degraded "
                             f"{res['degraded']}")
    for name in pop:
        if res["launches"][name] <= 0:
            raise AssertionError(f"durable: {name} kernel never launched in the resume")
    return row


def p2phandel() -> dict:
    """P2PHandel at the reference defaults (120 nodes, 40 connections),
    R = P2P_REPLICAS, P2P_MS ms on the 512-row wheel, with p2p_profile
    inside the run: nothing may drop and replica 0 must give the JAX
    package's seed-0 counters (P2P_R0)."""
    t_build = time.perf_counter()
    net, state = make_p2phandel()
    states = replicate_state(state, P2P_REPLICAS)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_build
    states, wall, ticks, launches, window = _profiled_run(net, states, P2P_MS, PROFILE_FROM,
                                                          "p2p_profile")
    done = states.done_at.cpu().numpy()
    down = states.down.cpu().numpy()
    dropped = states.dropped.cpu().numpy()
    r0 = p2p_replica0(states)
    out = {"nodes": int(done.shape[1]), "replicas": P2P_REPLICAS, "build_s": build_s,
           "wall_s": wall, "sims_per_s": P2P_REPLICAS / wall, "ticks": ticks,
           "ms_per_tick": wall / ticks * 1e3, "launches": launches,
           "launches_per_tick": {k: v / ticks for k, v in launches.items()},
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "replica0": r0, "dropped": int(dropped.sum()), **_quantiles(done, down)}
    emit({"phase": "p2phandel", **out})
    emit(window)
    if dropped.any():
        raise AssertionError(f"p2phandel: {int(dropped.sum())} messages dropped")
    _check_replica0("p2phandel", r0, P2P_R0)
    if launches["pack_bool_words"] <= 0:
        raise AssertionError("p2phandel: pack_bool_words kernel never launched")
    return out


def _timed_run(net, states, ms: int, stop_when_done: bool):
    """One event-driven run with the launch counts zeroed just before it
    and read just after; returns (states, wall seconds, launches)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    states = net.run_ms_batched(states, ms, stop_when_done)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return states, wall, {k.name: k.launches for k in kernels.KERNELS}


def _loop_numbers(net, replicas: int, wall: float, launches: dict) -> dict:
    it = net.jump_stats["iterations"]
    return {
        "replicas": replicas,
        "iterations": it,
        "wall_s": wall,
        "ms_per_iteration": wall / it * 1e3,
        "sims_per_s": replicas / wall,
        "launches": launches,
        "launches_per_iteration": {k: v / it for k, v in launches.items()},
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
    }


def pingpong() -> dict:
    """PingPong at PP_NODES nodes, R = PP_REPLICAS, run_ms_batched(PP_MS,
    stop_when_done=True) on the 512-row wheel, with pp_profile inside the
    run: every witness counts every pong, nothing drops, and the occupancy
    kernels launch."""
    t_build = time.perf_counter()
    net, state = make_pingpong(PP_NODES)
    states = replicate_state(state, PP_REPLICAS)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_build
    states, wall, launches, window = _windowed_jumps(net, states, PP_MS, True, "pp_profile")
    pong = states.proto["pong"][:, 0].cpu().numpy()
    # with stop_when_done a replica's last executed tick is the tick its
    # witness counted its last pong
    done_tick = net.jump_stats["last_tick"].cpu().numpy()
    q = np.percentile(done_tick, [10, 50, 90]).tolist()
    out = {**_jump_row("pingpong", net, PP_REPLICAS, build_s, wall, launches, window, states),
           "ms": PP_MS, "done_tick_p10": q[0], "done_tick_p50": q[1], "done_tick_p90": q[2],
           "done_tick_max": int(done_tick.max())}
    emit(out)
    emit(window)
    if not (pong == PP_NODES).all():
        raise AssertionError(f"pingpong: {(pong != PP_NODES).sum()} witnesses not done")
    if out["dropped"]:
        raise AssertionError(f"pingpong: {out['dropped']} messages dropped")
    for name in ("pack_occupied", "lowest_set_bit", "popcount_words"):
        if launches[name] <= 0:
            raise AssertionError(f"pingpong: {name} kernel never launched")
    if "pack_occupied_rows" not in window["hand_kernels_per_iteration"]:
        raise AssertionError("pp_profile: no pack_occupied_rows kernel in the window")
    out["_states"] = states  # faults_pingpong's neutral reference
    return out


def occupancy_probe() -> dict:
    """run_ms_occupancy, per-tick steps without jumps, on the first
    OCC_REPLICAS replicas of the PingPong run for OCC_MS ms on the card,
    and on its first four on the CPU: each replica's high-water marks and
    state equal across the two."""
    net, state = make_pingpong(PP_NODES, telemetry=TELE_CFG)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, marks = net.run_ms_occupancy(replicate_state(state, OCC_REPLICAS), OCC_MS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cnet, cstate = make_pingpong(PP_NODES, telemetry=TELE_CFG, device="cpu")
    cout, cmarks = cnet.run_ms_occupancy(replicate_state(cstate, 4), OCC_MS)
    got = state_to_numpy(map_state(lambda a: a[:4], out))
    bad = _leaf_diff(state_to_numpy(cout), got)
    fill, ovf = marks["wheel_fill_hwm"].cpu().numpy(), marks["overflow_hwm"].cpu().numpy()
    if not (np.array_equal(fill[:4], cmarks["wheel_fill_hwm"].numpy())
            and np.array_equal(ovf[:4], cmarks["overflow_hwm"].numpy())):
        bad.append("marks")
    if bad:
        raise AssertionError(f"occupancy probe: CUDA and CPU differ in {bad[:10]}")
    if not (fill > 0).all():
        raise AssertionError("occupancy probe: a replica's wheel never filled")
    return {"replicas": OCC_REPLICAS, "ms": OCC_MS, "wall_s": wall,
            "ms_per_tick": wall / OCC_MS * 1e3,
            "wheel_fill_hwm_p10_p50_p90": _percentiles(fill), "wheel_fill_hwm_max": int(fill.max()),
            "overflow_hwm_max": int(ovf.max()), "cpu_equal_replicas": 4}


def pingpong_tele(plain, plain_states) -> dict:
    """The pingpong phase's run with the telemetry side-car (TELE_CFG),
    ppt_profile inside it: every non-tele leaf equals the plain run's
    (`plain_states`), the store invariant and the ring's CDF hold per
    replica, the jump census is positive and each replica's tick census
    equals the loop's own count (`jump_stats`), and the occupancy kernels
    launch; ms and kernels an iteration beside the plain run's; then the
    occupancy probe."""
    t_build = time.perf_counter()
    net, state = make_pingpong(PP_NODES, telemetry=TELE_CFG)
    states = replicate_state(state, PP_REPLICAS)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_build
    states, wall, launches, window = _windowed_jumps(net, states, PP_MS, True, "ppt_profile")
    checks = _tele_checks("pingpong_tele", states)
    ticks = checks.pop("_ticks")
    ticks_equal = bool(np.array_equal(ticks, net.jump_stats["ticks"].cpu().numpy()))
    differ = None if plain_states is None else _differing_leaves(states, plain_states)
    out = {**_jump_row("pingpong_tele", net, PP_REPLICAS, build_s, wall, launches, window,
                       states),
           "ms": PP_MS,
           "plain_ms_per_iteration": None if plain is None else plain["ms_per_iteration"],
           "plain_kernels_per_iteration": None if plain is None else plain["kernels_per_iteration"],
           "plain_iterations": None if plain is None else plain["iterations"],
           "equal_plain": None if differ is None else not differ,
           "ticks_equal_jump_stats": ticks_equal, **checks}
    del states
    out["occupancy_probe"] = occupancy_probe()
    emit(out)
    emit(window)
    if differ:
        raise AssertionError(f"pingpong_tele: differs from the plain run in {differ}")
    if not ticks_equal:
        raise AssertionError("pingpong_tele: the tick census differs from jump_stats")
    if checks["jumps_total"] <= 0 or not checks["sent"]:
        raise AssertionError("pingpong_tele: no jump or no send counted")
    for name in ("pack_occupied", "lowest_set_bit", "popcount_words"):
        if launches[name] <= 0:
            raise AssertionError(f"pingpong_tele: {name} kernel never launched")
    return out


def dfinity() -> dict:
    net, state = make_dfinity(max_heights=64)
    states = replicate_state(state, DF_REPLICAS)
    states, wall, launches = _timed_run(net, states, DF_MS, False)
    dropped = states.dropped.cpu().numpy()
    heads = net.protocol.head_height(states).cpu().numpy()  # [R, N]
    ovf = states.ovf_valid.sum(-1).cpu().numpy()
    if dropped.any():
        raise AssertionError(f"dfinity: {int(dropped.sum())} messages dropped")
    # a replica's head height: the highest notarized block any of its
    # nodes holds
    replica_heads = heads.max(-1)
    if replica_heads.min() < 4:
        raise AssertionError(f"dfinity: a replica's head height is {replica_heads.min()} < 4")
    if launches["pack_occupied"] <= 0:
        raise AssertionError("dfinity: pack_occupied kernel never launched")
    out = {"nodes": int(heads.shape[1]), "ms": DF_MS, **_loop_numbers(net, DF_REPLICAS, wall, launches),
           "replica_head_min": int(replica_heads.min()), "node_head_min": int(heads.min()),
           "node_head_max": int(heads.max()),
           "overflow_live_mean": float(ovf.mean()), "overflow_live_max": int(ovf.max()),
           "dropped": int(dropped.sum())}
    emit({"phase": "dfinity", **out})
    return out


class _Kern(NamedTuple):
    """A device event of a profile window: its name and device us."""

    name: str
    device_time: float


class _CpuEv:
    """A CPU event of a profile window, as torch's processing nests it."""

    __slots__ = ("name", "start", "end", "thread", "async_", "kernels", "children", "parent",
                 "total")

    def __init__(self, name, start, end, thread, async_):
        self.name, self.start, self.end, self.thread = name, start, end, thread
        self.async_, self.kernels, self.children, self.parent = async_, [], [], None
        self.total = None

    def device_total(self) -> float:
        """device_time_total: own kernels, then the children's, summed as
        torch sums them."""
        if self.total is None:
            self.total = (0 if self.async_ else sum(self.kernels)
                          + sum(ch.device_total() for ch in self.children))
        return self.total


def _window_events(prof):
    """A profile window's device events (`_Kern`, in torch's event order)
    and each aten op's [calls, self device us] by name, in first-seen
    order: what prof.events() and prof.key_averages() give — the same
    filtered names, kernels linked to the op that launched them, the same
    nesting per thread, the same merge of a lone same-name child into its
    parent, the same float sums in the same order — read from the raw
    Kineto events without building torch's per-event Python objects,
    whose processing took 164.8 s of a 753-s run of this script (H100
    80GB HBM3 at 700 W).  The p2pflood window holds the two readings
    equal in every run."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _filter_name

    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    names = {}

    def rename(raw: str) -> str:  # torch's StringTable: demangled
        if raw not in names:
            names[raw] = torch._C._demangle(raw) if len(raw) > 1 else raw
        return names[raw]

    evs, frontend, linked = [], [], {}
    for k in res.events():
        raw = k.name()
        if _filter_name(raw) or getattr(k, "is_hidden_event", lambda: False)():
            continue
        start, end = (k.start_ns() - t0) / 1000, (k.end_ns() - t0) / 1000
        dev = k.device_type()
        if dev == DeviceType.CPU:
            ev = _CpuEv(rename(raw), start, end, k.start_thread_id(),
                        k.is_async() or k.start_thread_id() != k.end_thread_id())
        elif dev == DeviceType.CUDA:
            ev = _Kern(rename(raw), end - start)
        else:
            ev = None
        evs.append((start, -end, ev))
        corr = k.linked_correlation_id()
        if corr > 0:
            linked.setdefault(corr, []).append(ev)
        elif corr == 0 and isinstance(ev, _CpuEv):
            frontend.append((k.correlation_id(), ev))
    for cid, ev in frontend:
        if not ev.async_:
            for f in linked.get(cid, ()):
                if isinstance(f, _Kern):
                    ev.kernels.append(f.device_time)
                elif isinstance(f, _CpuEv):
                    f.thread = ev.thread
    evs.sort(key=lambda e: (e[0], e[1]))
    order = [e[2] for e in evs if e[2] is not None]
    cpu = [e for e in order if isinstance(e, _CpuEv)]
    # nesting: per thread, by (start, -end), a stack of open parents
    for _, group in itertools.groupby(sorted((e for e in cpu if not e.async_),
                                             key=lambda e: e.thread), key=lambda e: e.thread):
        stack = []
        for ev in group:
            while stack:
                parent = stack[-1]
                if ev.start >= parent.end or ev.end > parent.end:
                    stack.pop()
                else:
                    parent.children.append(ev)
                    ev.parent = parent
                    break
            stack.append(ev)
    # a lone child of its parent's name merges into it (kernels lifted)
    while True:
        gone = set()
        for i, ev in enumerate(cpu):
            p = ev.parent
            if p is not None and p.name == ev.name and len(p.children) == 1:
                p.children, p.kernels = ev.children, ev.kernels
                for ch in ev.children:
                    ch.parent = p
                gone.add(i)
        if not gone:
            break
        cpu = [ev for i, ev in enumerate(cpu) if i not in gone]
    ops = {}
    for ev in cpu:
        if ev.name.startswith("aten::"):
            row = ops.setdefault(ev.name, [0, 0])
            row[0] += 1
            if not ev.async_:
                row[1] += ev.device_total() - sum(ch.device_total() for ch in ev.children)
    return [e for e in order if isinstance(e, _Kern)], ops


def _torch_window_events(prof):
    """The same reading through torch's own processing (prof.events(),
    prof.key_averages()), for the cross-check."""
    from torch.autograd import DeviceType

    kern = [_Kern(e.name, e.device_time) for e in prof.events()
            if e.device_type == DeviceType.CUDA]
    ops = {e.key: [e.count, e.self_device_time_total] for e in prof.key_averages()
           if e.key.startswith("aten::")}
    return kern, ops


@contextlib.contextmanager
def _gc_paused():
    """A window's reading builds ~10^5 small objects, and the cyclic
    collector's passes over them took half of the reading's time; it
    runs again when the reading is done."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def _check_reading(prof, phase: str) -> float:
    """Hold a window's raw-event reading equal to torch's own; returns the
    seconds torch's reading took."""
    t0 = time.perf_counter()
    with _gc_paused():
        want = _torch_window_events(prof)
    torch_s = time.perf_counter() - t0
    with _gc_paused():
        kern, ops = _window_events(prof)
    if (kern, ops) != want:
        bad = sorted(k for k in set(ops) | set(want[1]) if ops.get(k) != want[1].get(k))
        raise AssertionError(f"{phase}: the raw-event reading differs from torch's: "
                             f"{len(kern)} vs {len(want[0])} device events, ops {bad[:8]}")
    return torch_s


def _window_reading(prof, phase: str):
    """(kern, the aten ops sorted by self device time, most first) of a
    window."""
    with _gc_paused():
        kern, ops = _window_events(prof)
    if not kern:
        raise AssertionError(f"{phase}: the profiler recorded no device activity")
    top = sorted(ops.items(), key=lambda kv: kv[1][1], reverse=True)
    return kern, top


def _profile_ticks(net, states, ticks: int, phase: str, stop_when_done: bool = False):
    """A torch.profiler window of `ticks` ticks inside a lockstep run;
    returns (states, the window's numbers)."""
    from torch.profiler import ProfilerActivity, profile

    t0 = int(states.time.reshape(-1)[0])
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with prof:
        states = net.run_ms_batched(states, ticks, stop_when_done)
        torch.cuda.synchronize()
        t_close = time.perf_counter()
    kern, ops = _window_reading(prof, phase)
    return states, {
        # the profiler's own seconds from the window's close to its numbers
        "profiler_s": time.perf_counter() - t_close,
        "phase": phase,
        "window_ticks": [t0, t0 + ticks],
        "kernels_per_tick": len(kern) / ticks,
        "device_ms_per_tick": sum(e.device_time for e in kern) / 1e3 / ticks,
        "hand_kernels_per_tick": device_ms_by_kernel(kern, ticks),
        "popcount_forms_per_tick": forms_by_kernel(kern, ticks),
        "top_ops": [
            {"op": op, "calls_per_tick": calls / ticks, "device_ms_per_tick": dev / 1e3 / ticks}
            for op, (calls, dev) in ops[:10]
        ],
    }


def _profiled_run(net, states, ms: int, at: int, phase: str):
    """A lockstep run of `ms` ticks as a user drives it, with the launch
    counts zeroed just before and read just after, and a PROFILE_TICKS
    window at tick `at` inside it.  The window's ticks are left out of the
    wall time, which is the rest's scaled to the whole run.  Returns
    (states, wall seconds, ticks, launches, the window's numbers)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    wall = 0.0
    t0 = time.perf_counter()
    states = net.run_ms_batched(states, at)
    torch.cuda.synchronize()
    wall += time.perf_counter() - t0
    states, window = _profile_ticks(net, states, PROFILE_TICKS, phase)
    t0 = time.perf_counter()
    states = net.run_ms_batched(states, ms - at - PROFILE_TICKS)
    torch.cuda.synchronize()
    wall += time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels.KERNELS}
    wall *= ms / (ms - PROFILE_TICKS)
    window["device_busy_share"] = window["device_ms_per_tick"] / (wall / ms * 1e3)
    return states, wall, ms, launches, window


def eth2_cards(states) -> np.ndarray:
    """[R, N] incoming contributions per node: at every level complete,
    1 + 1 + 2 + ... + 128 for the height-1001 process, the other slots
    still empty."""
    inc = states.proto["inc"]
    return bitops.popcount_words(inc.reshape(inc.shape[0], ETH2_NODES, -1)).cpu().numpy()


def eth2_replica0(states) -> dict:
    """HandelEth2's replica-0 traffic (ETH2_R0)."""
    p = states.proto
    return {"msg_received": int(states.msg_received[0].sum()),
            "msg_sent": int(states.msg_sent[0].sum()),
            "rr_bump": int(p["rr_bump"][0].sum()),
            "window_min": int(p["window"][0].min()), "window_max": int(p["window"][0].max())}


def handeleth2() -> dict:
    """HandelEth2 at 256 nodes (the default parameters otherwise), R =
    ETH2_REPLICAS, ETH2_MS ms on the 512-row wheel, with eth2_profile at
    ticks 1000-1009."""
    t_build = time.perf_counter()
    net, state = make_handeleth2(HandelEth2Parameters(node_count=ETH2_NODES))
    states = replicate_state(state, ETH2_REPLICAS)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_build
    states, wall, ticks, launches, window = _profiled_run(net, states, ETH2_MS, 1000,
                                                          "eth2_profile")
    dropped = states.dropped.cpu().numpy()
    if dropped.any():
        raise AssertionError(f"handeleth2: {int(dropped.sum())} messages dropped")
    card = eth2_cards(states)
    if not (card == ETH2_NODES).all():
        short = np.argwhere(card != ETH2_NODES)
        raise AssertionError(f"handeleth2: {len(short)} (replica, node) pairs short of "
                             f"{ETH2_NODES}, first {short[:5].tolist()}")
    r0 = eth2_replica0(states)
    _check_replica0("handeleth2", r0, ETH2_R0)
    for name in ("popcount_words", "popcount_binop"):
        if launches[name] <= 0:
            raise AssertionError(f"handeleth2: {name} kernel never launched")
    out = {"nodes": ETH2_NODES, "replicas": ETH2_REPLICAS, "ms": ETH2_MS,
           "build_s": build_s, "wall_s": wall,
           "ms_per_tick": wall / ticks * 1e3, "sims_per_s": ETH2_REPLICAS / wall,
           "launches": launches, "launches_per_tick": {k: v / ETH2_MS for k, v in launches.items()},
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "replica0": r0, "msg_received_per_replica_min": int(
               states.msg_received.sum(-1).min()),
           "dropped": int(dropped.sum())}
    emit({"phase": "handeleth2", **out})
    emit(window)
    return out


def sf_replica0(states) -> dict:
    """SanFermin's replica-0 outcome (SF_R0)."""
    p = states.proto
    done = p["done"][0].cpu().numpy()
    thr = p["thr_at"][0].cpu().numpy()[done]
    q = np.percentile(thr, [10, 50, 90], method="nearest").astype(int).tolist() if thr.size else []
    return {"done": int(done.sum()), "thr_at_p10_p50_p90": q,
            "thr_at_min": int(thr.min()) if thr.size else None,
            "thr_at_max": int(thr.max()) if thr.size else None,
            "msg_received": int(states.msg_received[0].sum()),
            "sent_req": int(p["sent_req"][0].sum())}


def sanfermin() -> dict:
    """SanFermin at 4096 nodes (BASELINE config 5 with Dfinity), capacity
    SF_CAPACITY, R = SF_REPLICAS, SF_MS ms, with sf_profile at ticks
    1000-1009."""
    t_build = time.perf_counter()
    net, state = make_sanfermin(sf_params(SF_NODES), capacity=SF_CAPACITY)
    states = replicate_state(state, SF_REPLICAS)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_build
    states, wall, ticks, launches, window = _profiled_run(net, states, SF_MS, SF_PROFILE_AT,
                                                          "sf_profile")
    p = states.proto
    dropped = states.dropped.cpu().numpy()
    if dropped.any():
        raise AssertionError(f"sanfermin: {int(dropped.sum())} messages dropped")
    done = p["done"].cpu().numpy()
    r0 = sf_replica0(states)
    _check_replica0("sanfermin", r0, SF_R0)
    per_replica = done.sum(-1)
    out = {"nodes": SF_NODES, "replicas": SF_REPLICAS, "ms": SF_MS, "capacity": SF_CAPACITY,
           "build_s": build_s, "wall_s": wall, "ms_per_tick": wall / ticks * 1e3,
           "sims_per_s": SF_REPLICAS / wall, "launches": launches,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "replica0": r0, "done_share": float(done.mean()),
           "done_per_replica_min": int(per_replica.min()),
           "done_per_replica_max": int(per_replica.max()),
           "replicas_all_done": int((per_replica == SF_NODES).sum()),
           "dropped": int(dropped.sum())}
    emit({"phase": "sanfermin", **out})
    emit(window)
    return out


def _iteration_window(prof, phase: str, start: int, per: int) -> dict:
    """A profiled window of `per` loop iterations from iteration `start`,
    per iteration: kernels, device ms, the hand-written kernels and the
    ops that take the device time."""
    kern, ops = _window_reading(prof, phase)
    return {
        "phase": phase,
        "window_iterations": [start, start + per],
        "kernels_per_iteration": len(kern) / per,
        "device_ms_per_iteration": sum(e.device_time for e in kern) / 1e3 / per,
        "hand_kernels_per_iteration": device_ms_by_kernel(kern, per),
        "top_ops": [
            {"op": op, "calls_per_iteration": calls / per,
             "device_ms_per_iteration": dev / 1e3 / per}
            for op, (calls, dev) in ops[:12]
        ],
    }


def _windowed_jumps(net, states, ms: int, stop_when_done: bool, phase: str,
                    start: int = PROFILE_FROM, per: int = PROFILE_TICKS, check: bool = False):
    """An event-driven run as a user drives it (run_ms_batched), with the
    launch counts zeroed just before and read just after, and a `per`-
    iteration torch.profiler window from iteration `start` inside it.  The
    window's iterations are left out of the wall time, which is the rest's
    scaled to the whole run.  With `check`, the window's reading is held
    equal to torch's own (`torch_reading_s` its seconds).  Returns
    (states, wall seconds, launches, window)."""
    from torch.profiler import ProfilerActivity, profile

    step, done, window_s, close_s = net._step_jump, [0], [0.0], [0.0]
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def stepped(s, t, ends):
        if done[0] == start:
            torch.cuda.synchronize()
            window_s[0] -= time.perf_counter()
            prof.__enter__()
        out = step(s, t, ends)
        done[0] += 1
        if done[0] == start + per:
            torch.cuda.synchronize()
            t_close = time.perf_counter()
            prof.__exit__(None, None, None)
            now = time.perf_counter()
            close_s[0] = now - t_close
            window_s[0] += now
        return out

    net._step_jump = stepped
    try:
        states, wall, launches = _timed_run(net, states, ms, stop_when_done)
    finally:
        del net._step_jump  # the class's method again
    if done[0] < start + per:
        raise AssertionError(f"{phase}: the run ended before its profiled window closed")
    t_parse = time.perf_counter()
    window = _iteration_window(prof, phase, start, per)
    # the profiler's own seconds from the window's close to its numbers
    window["profiler_s"] = close_s[0] + time.perf_counter() - t_parse
    if check:
        window["torch_reading_s"] = _check_reading(prof, phase)
    it = net.jump_stats["iterations"]
    wall = (wall - window_s[0]) * it / (it - per)
    window["device_busy_share"] = window["device_ms_per_iteration"] / (wall / it * 1e3)
    return states, wall, launches, window


def _check_replica0(path: str, got: dict, want: dict) -> None:
    if got != want:
        raise AssertionError(f"{path}: replica 0 gives {got}, the JAX package {want}")


def _percentiles(x: np.ndarray) -> list:
    return [round(float(v), 6) for v in np.percentile(x, [10, 50, 90])]


def _jump_row(path: str, net, replicas: int, build_s: float, wall: float, launches: dict,
              window: dict, states) -> dict:
    """The numbers of an event-driven run and its window, as one row."""
    it = net.jump_stats["iterations"]
    return {"phase": path, "nodes": net.n_nodes, "replicas": replicas,
            "capacity": net.capacity, "build_s": build_s, "iterations": it,
            "wall_s": wall, "ms_per_iteration": wall / it * 1e3,
            "sims_per_s": replicas / wall, "launches": launches,
            "launches_per_iteration": {k: v / it for k, v in launches.items()},
            "kernels_per_iteration": window["kernels_per_iteration"],
            "device_ms_per_iteration": window["device_ms_per_iteration"],
            "device_busy_share": window["device_busy_share"],
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "dropped": int(states.dropped.sum())}


def avalanche(path: str) -> dict:
    """Slush or Snowflake at the reference main, R = AV_REPLICAS,
    run_ms_batched(AV_MS, stop_when_done=True) on the 512-row wheel: every
    node of every replica colored and none querying, nothing dropped,
    replica 0 equal to the JAX package's seed-0 run, and the occupancy
    kernels launched."""
    make, params = AV_PATHS[path]
    t_build = time.perf_counter()
    net, state = make(params())
    states = replicate_state(state, AV_REPLICAS)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_build
    states, wall, launches, window = _windowed_jumps(net, states, AV_MS, True,
                                                            f"{path}_profile")
    p = states.proto
    out = _jump_row(path, net, AV_REPLICAS, build_s, wall, launches, window, states)
    last = net.jump_stats["last_tick"].cpu().numpy()
    r0 = {"color": int(p["color"][0].sum()), "iter": int(p["iter"][0].sum()),
          "nonce": int(p["nonce"][0].sum()), "msg_received": int(states.msg_received[0].sum()),
          "msg_sent": int(states.msg_sent[0].sum())}
    out.update({"quiet_tick_p10_p50_p90": _percentiles(last), "quiet_tick_max": int(last.max()),
                "replica0": r0})
    emit(out)
    emit(window)
    colored = bool((p["color"] == 1).logical_or(p["color"] == 2).all())
    if not colored or bool(p["active"].any()):
        raise AssertionError(f"{path}: a replica is not colored and quiescent")
    if out["dropped"]:
        raise AssertionError(f"{path}: {out['dropped']} messages dropped")
    _check_replica0(path, r0, AV_R0[path])
    for name in ("pack_occupied", "lowest_set_bit", "popcount_words"):
        if launches[name] <= 0:
            raise AssertionError(f"{path}: {name} kernel never launched")
    return out


def p2pflood() -> dict:
    """P2PFlood at the reference defaults, R = FLOOD_REPLICAS, FLOOD_MS
    with stop_when_done on the flat store: every live node reached,
    nothing dropped, replica 0 equal to the JAX package's seed-0 run.
    Its path calls no hand-written kernel."""
    t_build = time.perf_counter()
    net, state = make_p2pflood(capacity=FLOOD_CAPACITY)
    states = replicate_state(state, FLOOD_REPLICAS)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_build
    states, wall, launches, window = _windowed_jumps(net, states, FLOOD_MS, True,
                                                     "p2pflood_profile", check=True)
    out = _jump_row("p2pflood", net, FLOOD_REPLICAS, build_s, wall, launches, window, states)
    done, down = states.done_at.cpu().numpy(), states.down.cpu().numpy()
    d0 = done[0][~down[0]]
    r0 = {"done": int((d0 > 0).sum()), "done_at_p10_p50_p90": _percentiles(d0),
          "done_at_max": int(d0.max()), "msg_received": int(states.msg_received[0].sum()),
          "msg_sent": int(states.msg_sent[0].sum())}
    live = done[~down]
    out.update({"done_share": float((live > 0).mean()),
                "done_at_p10_p50_p90": _percentiles(live), "replica0": r0})
    emit(out)
    emit(window)
    if out["done_share"] != 1.0:
        raise AssertionError(f"p2pflood: done share {out['done_share']}")
    if out["dropped"]:
        raise AssertionError(f"p2pflood: {out['dropped']} messages dropped")
    _check_replica0("p2pflood", r0, FLOOD_R0)
    return out


def optimistic() -> dict:
    """OptimisticP2PSignature at 1000 nodes (threshold 501, 13
    connections, pairing time 3), capacity OPT_CAPACITY on the flat store,
    R = OPT_REPLICAS, OPT_MS with stop_when_done: every node of every
    replica done, nothing dropped, replica 0 equal to the JAX package's
    seed-0 run.  Its path calls no hand-written kernel."""
    t_build = time.perf_counter()
    net, state = make_optimistic(OptimisticP2PSignatureParameters(1000, 501, 13, 3),
                                 capacity=OPT_CAPACITY)
    states = replicate_state(state, OPT_REPLICAS)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_build
    states, wall, launches, window = _windowed_jumps(net, states, OPT_MS, True,
                                                            "optimistic_profile")
    out = _jump_row("optimistic", net, OPT_REPLICAS, build_s, wall, launches, window, states)
    done = states.done_at.cpu().numpy()
    r0 = {"done": int((done[0] > 0).sum()), "done_at_p10_p50_p90": _percentiles(done[0]),
          "done_at_min": int(done[0].min()), "done_at_max": int(done[0].max()),
          "received_bits": int(states.proto["received"][0].sum()),
          "msg_received": int(states.msg_received[0].sum()),
          "msg_sent": int(states.msg_sent[0].sum()), "pending": int(states.ovf_valid[0].sum())}
    out.update({"done_share": float((done > 0).mean()),
                "done_at_p10_p50_p90": _percentiles(done),
                "msg_sent_per_replica": states.msg_sent.sum(-1).tolist(), "replica0": r0})
    emit(out)
    emit(window)
    if out["done_share"] != 1.0:
        raise AssertionError(f"optimistic: done share {out['done_share']}")
    if out["dropped"]:
        raise AssertionError(f"optimistic: {out['dropped']} messages dropped")
    _check_replica0("optimistic", r0, OPT_R0)
    return out


def cappos_replica0(states) -> dict:
    """SanFerminCappos's replica-0 outcome (CAPPOS_R0)."""
    p = states.proto
    done, thr_done = p["done"][0].cpu().numpy(), p["thr_done"][0].cpu().numpy()
    d0 = states.done_at[0].cpu().numpy()[done]
    t0 = p["thr_at"][0].cpu().numpy()[thr_done]
    return {"done": int(done.sum()), "not_done": np.nonzero(~done)[0].tolist(),
            "done_at_p10_p50_p90": _percentiles(d0), "done_at_min": int(d0.min()),
            "done_at_max": int(d0.max()), "thr_done": int(thr_done.sum()),
            "thr_at_p10_p50_p90": _percentiles(t0),
            "msg_received": int(states.msg_received[0].sum()),
            "msg_sent": int(states.msg_sent[0].sum()), "cpl": int(p["cpl"][0].sum())}


def cappos() -> dict:
    """SanFerminCappos at 1024 nodes (threshold 512, 50 candidates),
    capacity CAPPOS_CAPACITY on the 512-row wheel, R = CAPPOS_REPLICAS,
    CAPPOS_MS ms, with cappos_profile at ticks 300-309: nothing dropped,
    replica 0 equal to the JAX package's seed-0 run.  Its path calls no
    hand-written kernel (the per-ms loop reads no wheel occupancy)."""
    t_build = time.perf_counter()
    net, state = make_sanfermin_cappos(SanFerminParameters(1024, 512, 2, 48, 150, 50),
                                       capacity=CAPPOS_CAPACITY)
    states = replicate_state(state, CAPPOS_REPLICAS)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_build
    states, wall, ticks, launches, window = _profiled_run(net, states, CAPPOS_MS,
                                                          CAPPOS_PROFILE_AT, "cappos_profile")
    done, done_at = states.proto["done"].cpu().numpy(), states.done_at.cpu().numpy()
    r0 = cappos_replica0(states)
    out = {"phase": "cappos", "nodes": net.n_nodes, "replicas": CAPPOS_REPLICAS,
           "ms": CAPPOS_MS, "capacity": CAPPOS_CAPACITY, "wheel_slots": net.wheel_slots,
           "build_s": build_s, "ticks": ticks, "wall_s": wall,
           "ms_per_tick": wall / ticks * 1e3, "sims_per_s": CAPPOS_REPLICAS / wall,
           "launches": launches,
           "launches_per_tick": {k: v / CAPPOS_MS for k, v in launches.items()},
           "kernels_per_tick": window["kernels_per_tick"],
           "device_ms_per_tick": window["device_ms_per_tick"],
           "device_busy_share": window["device_busy_share"],
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "done_share": float(done.mean()), "done_at_p10_p50_p90": _percentiles(done_at[done]),
           "replica0": r0, "dropped": int(states.dropped.sum())}
    emit(out)
    emit(window)
    if out["dropped"]:
        raise AssertionError(f"cappos: {out['dropped']} messages dropped")
    _check_replica0("cappos", r0, CAPPOS_R0)
    return out


def enr_replica0(states) -> dict:
    """Replica 0's state in the numbers of the JAX package's seed-0 run."""
    p = {k: v[0].cpu().numpy() for k, v in states.proto.items()}
    adj, alive = p["adj"], p["alive"]
    deg = adj.sum(1)
    return {"alive": int(alive.sum()), "adj_cells": int(adj.sum()), "max_degree": int(deg.max()),
            "min_alive_degree": int(deg[alive].min()),
            "id_weighted_degree": int((np.arange(deg.size) * deg).sum()),
            "adj_md5_12": hashlib.md5(adj.astype(np.uint8).tobytes()).hexdigest()[:12],
            "records": int(p["records"].sum()), "seen_cells": int((p["seen"] >= 0).sum()),
            "seen_max": int(p["seen"].max()),
            "msg_received": int(states.msg_received[0].sum()),
            "msg_sent": int(states.msg_sent[0].sum()),
            "pending": int(states.ovf_valid[0].sum()),
            "done_at_sum": int(states.done_at[0].sum()), "last_t": int(p["last_t"]),
            "bcast_next_min": int(p["bcast_next"].min())}


def enr() -> dict:
    """ENRGossiping at the reference main (131 slots), capacity
    ENR_CAPACITY on the flat store, R = ENR_REPLICAS, ENR_MS at a fixed
    depth, with enr_profile inside the run: nothing dropped, every
    replica's adjacency symmetric, loop-free and on alive slots only with
    51 slots alive, replica 0 equal to the JAX package's seed-0 run.  Its
    path calls no hand-written kernel."""
    t_build = time.perf_counter()
    net, state = make_enr(ENRParameters(), horizon_ms=ENR_HORIZON, capacity=ENR_CAPACITY)
    states = replicate_state(state, ENR_REPLICAS)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_build
    states, wall, launches, window = _windowed_jumps(net, states, ENR_MS, False, "enr_profile")
    out = _jump_row("enr", net, ENR_REPLICAS, build_s, wall, launches, window, states)
    p = states.proto
    adj, alive = p["adj"], p["alive"]
    r0 = enr_replica0(states)
    out.update({"ms": ENR_MS, "replica0": r0,
                "adj_cells_p10_p50_p90": _percentiles(adj.sum((1, 2)).cpu().numpy()),
                "records_p10_p50_p90": _percentiles(p["records"].sum(-1).cpu().numpy()),
                "msg_received_p10_p50_p90": _percentiles(
                    states.msg_received.sum(-1).cpu().numpy())})
    emit(out)
    emit(window)
    if out["dropped"]:
        raise AssertionError(f"enr: {out['dropped']} messages dropped")
    if not bool((adj == adj.transpose(1, 2)).all()):
        raise AssertionError("enr: an adjacency is not symmetric")
    if bool(adj.diagonal(dim1=1, dim2=2).any()) or bool((adj.any(-1) & ~alive).any()):
        raise AssertionError("enr: a self-loop or a link on a dead slot")
    if not bool((alive.sum(-1) == 51).all()):
        raise AssertionError(f"enr: alive slots {alive.sum(-1).unique().tolist()}, not 51")
    if any(launches.values()):
        raise AssertionError(f"enr: the flat-store path launched kernels: {launches}")
    _check_replica0("enr", r0, ENR_R0)
    return out


def _windowed_calls(obj, name: str, run, phase: str, start: int, per: int):
    """A run as a user drives it (`run()`), with the launch counts zeroed
    just before and read just after, and a torch.profiler window over
    calls start .. start + per - 1 of obj.<name> (an event-loop iteration
    or a tick) inside it.  The window's seconds are left out of the
    returned wall time.  Returns (run's result, wall seconds without the
    window, calls, launches, window)."""
    from torch.profiler import ProfilerActivity, profile

    orig = getattr(obj, name)
    calls, window_s, close_s = [0], [0.0], [0.0]
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def wrapped(*args, **kw):
        if calls[0] == start:
            torch.cuda.synchronize()
            window_s[0] -= time.perf_counter()
            prof.__enter__()
        elif calls[0] == start + per:
            torch.cuda.synchronize()
            t_close = time.perf_counter()
            prof.__exit__(None, None, None)
            now = time.perf_counter()
            close_s[0] = now - t_close
            window_s[0] += now
        calls[0] += 1
        return orig(*args, **kw)

    setattr(obj, name, wrapped)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels.KERNELS}
    finally:
        delattr(obj, name)  # the class's method again
    if calls[0] <= start + per:
        raise AssertionError(f"{phase}: the run ended before its profiled window closed")
    t_parse = time.perf_counter()
    window = _iteration_window(prof, phase, start, per)
    window["profiler_s"] = close_s[0] + time.perf_counter() - t_parse
    return out, wall - window_s[0], calls[0], launches, window


def _scaled(wall: float, count: int, per: int, window: dict) -> float:
    """The run's wall time with its window's share restored at the rest's
    rate; sets the window's busy share."""
    wall = wall * count / (count - per)
    window["device_busy_share"] = window["device_ms_per_iteration"] / (wall / count * 1e3)
    return wall


def ethpow_chain(states) -> dict:
    """Per replica, the public chain seen by miner 0 (chain_producers'
    scope): its tip, length and the pos-1 miner's blocks on it."""
    known = states.arrival[:, :, 0] <= states.time[:, None]
    tip = torch.where(known, states.td, -1.0).argmax(1).to(torch.int32)
    stop = (torch.arange(states.td.shape[1], device=tip.device) == 0).expand_as(known)
    own = (states.producer == 1).to(torch.int32)
    total = chain_count(states.parent, tip, stop, torch.ones_like(own))
    mine = chain_count(states.parent, tip, stop, own)
    return {"tip": tip.cpu().numpy(), "chain": total.cpu().numpy(), "mine": mine.cpu().numpy()}


def ethpow() -> dict:
    """ETHPoW at the reference's 10 miners, b_max ETH_B_MAX, R =
    ETH_REPLICAS, ETH_MS ms through the event loop, honest and under each
    selfish miner at 45%: nothing overflows, the selfish mean revenue
    ratio is above 0.5, replica 0 equals the JAX package's seed-0 run
    (ETH_R0).  Each config's ethpow_<config>_profile is a 10-iteration
    window from iteration 100.  No hand-written kernel on its path."""
    out = {"phase": "ethpow", "replicas": ETH_REPLICAS, "ms": ETH_MS, "configs": {}}
    total_launches = {k.name: 0 for k in kernels.KERNELS}
    # the exp check's CPU half runs in a worker beside the runs, which
    # hold one core of the host
    pool = multiprocessing.get_context("spawn").Pool(1)
    try:
        return _ethpow_runs(out, total_launches, pool.apply_async(exp_digests, ("cpu",)))
    finally:
        pool.terminate()
        pool.join()


def _ethpow_runs(out: dict, total_launches: dict, cpu_digests) -> dict:
    """ethpow's three runs, then the x-range line and the exp check."""
    x_lo = x_hi = None  # the thresholds' arguments over every run, on the card
    for config, kw in ETH_CONFIGS.items():
        torch.cuda.synchronize()
        t_build = time.perf_counter()
        net = BatchedEthPow(ETHPoWParameters(number_of_miners=ETH_MINERS, **kw), b_max=ETH_B_MAX)
        x_range = [None, None]

        def thresholds(cand_diff, net=net, x_range=x_range):
            x = -net.hp_per_10ms / cand_diff
            lo, hi = x.amin(), x.amax()
            x_range[0] = lo if x_range[0] is None else torch.minimum(x_range[0], lo)
            x_range[1] = hi if x_range[1] is None else torch.maximum(x_range[1], hi)
            return BatchedEthPow.thresholds(net, cand_diff)

        net.thresholds = thresholds
        states = replicate_ethpow(net.init_state(), ETH_REPLICAS)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t_build
        phase = f"ethpow_{config}_profile"
        states, wall, it, launches, window = _windowed_calls(
            net, "_next_events", lambda: net.run_ms(states, ETH_MS), phase, PROFILE_FROM,
            PROFILE_TICKS)
        wall = _scaled(wall, it, PROFILE_TICKS, window)
        ch = ethpow_chain(states)
        ratio = ch["mine"] / np.maximum(ch["chain"], 1)
        s0 = {f: getattr(states, f)[0].cpu().numpy() for f in ("n_blocks", "blocks_mined",
                                                                "overflowed")}
        r0 = {"n_blocks": int(s0["n_blocks"]), "chain": int(ch["chain"][0]),
              "tip": int(ch["tip"][0]),
              "revenue_ratio": int(ch["mine"][0]) / int(ch["chain"][0]),
              "blocks_mined": s0["blocks_mined"].tolist(), "overflowed": int(s0["overflowed"])}
        beats = net.jump_stats["beats"].cpu().numpy()
        row = {"config": config, "build_s": build_s, "iterations": it, "wall_s": wall,
               "ms_per_iteration": wall / it * 1e3, "sims_per_s": ETH_REPLICAS / wall,
               "kernels_per_iteration": window["kernels_per_iteration"],
               "device_ms_per_iteration": window["device_ms_per_iteration"],
               "device_busy_share": window["device_busy_share"],
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "full_beats_p10_p50_p90": _percentiles(beats), "beats_of_grid": ETH_MS // 10,
               "n_blocks_p10_p50_p90": _percentiles(states.n_blocks.cpu().numpy()),
               "revenue_ratio_mean": float(ratio.mean()),
               "overflowed": int(states.overflowed.sum()), "launches": launches, "replica0": r0}
        out["configs"][config] = row
        emit({"phase": "ethpow", **row})
        emit(window)
        if row["overflowed"]:
            raise AssertionError(f"ethpow {config}: {row['overflowed']} blocks overflowed")
        if config != "honest" and not row["revenue_ratio_mean"] > 0.5:
            raise AssertionError(
                f"ethpow {config}: mean revenue ratio {row['revenue_ratio_mean']}")
        if any(launches.values()):
            raise AssertionError(f"ethpow: its path launched kernels: {launches}")
        _check_replica0(f"ethpow {config}", r0, ETH_R0[config])
        for k, v in launches.items():
            total_launches[k] += v
        x_lo = x_range[0] if x_lo is None else torch.minimum(x_lo, x_range[0])
        x_hi = x_range[1] if x_hi is None else torch.maximum(x_hi, x_range[1])
        del net, states
    out["launches"] = total_launches
    # the arguments of every threshold the runs took, read once: they must
    # lie in the covered range, where exp_f32 is XLA's exp bit for bit
    x_min, x_max = float(x_lo), float(x_hi)
    covered = EXP_COVERED[0] <= -x_max and -x_min < EXP_COVERED[1]
    row = {"phase": "ethpow_x_range", "x_min": x_min, "x_max": x_max,
           "log2_neg_x": [float(np.log2(-x_max)), float(np.log2(-x_min))],
           "covered_neg_x": list(EXP_COVERED), "inside": covered, **exp_check(cpu_digests)}
    emit(row)
    if not covered:
        raise AssertionError(f"ethpow: threshold arguments [{x_min}, {x_max}] leave the covered "
                             f"range -x in {EXP_COVERED}")
    if row["exp_cuda_differ"]:
        raise AssertionError(f"ethpow: exp_f32 differs on CUDA from the CPU on "
                             f"{row['exp_cuda_differ']} arguments")
    out["x_range"] = [x_min, x_max]
    return out


def _exp_binade(e: int, device: str) -> torch.Tensor:
    """The thresholds 1 - exp_f32(x), as int32 bits, of every float32 x with
    -x in [2^e, 2^(e+1)) (2^23 arguments), computed on `device`."""
    first = int(np.float32(2.0**e).view(np.int32))
    x = -torch.arange(first, first + (1 << 23), dtype=torch.int32).view(torch.float32)
    return (1.0 - exp_f32(x.to(device))).view(torch.int32).cpu()


@torch.inference_mode()
def exp_digests(device: str) -> list:
    """sha256 of _exp_binade's bits for each binade of EXP_COVERED."""
    if device == "cpu":
        torch.set_num_threads(4)
    lo_e, hi_e = (int(np.log2(v)) for v in EXP_COVERED)
    return [hashlib.sha256(_exp_binade(e, device).numpy().tobytes()).hexdigest()
            for e in range(lo_e, hi_e)]


def exp_check(cpu_digests) -> dict:
    """exp_f32, and so the thresholds, on CUDA against the CPU over every
    float32 x with -x in the covered range EXP_COVERED, binade by binade:
    the CPU's digests come from a worker process that ran beside the
    ETHPoW runs (`cpu_digests`, its async result); a binade whose digests
    differ is recomputed here to count the arguments that differ."""
    t0 = time.perf_counter()
    cuda = exp_digests("cuda")
    cpu = cpu_digests.get()
    lo_e, hi_e = (int(np.log2(v)) for v in EXP_COVERED)
    bad = 0
    for e, a, b in zip(range(lo_e, hi_e), cpu, cuda):
        if a != b:
            bad += int((_exp_binade(e, "cpu") != _exp_binade(e, "cuda")).sum())
    return {"exp_arguments": (hi_e - lo_e) << 23, "exp_binades": hi_e - lo_e,
            "exp_cuda_differ": bad, "exp_check_s": time.perf_counter() - t0}


def miner_env() -> dict:
    """BatchedMinerEnv at create_agent's configuration, R = MINER_REPLICAS,
    MINER_STEPS steps of MINER_DECISION_MS under `miner_policy`, with a
    MINER_PROFILE_STEPS-step miner_env_profile window from step 100:
    nothing overflows and
    replica 0's last observation equals the JAX environment's (MINER_R0).
    No hand-written kernel on its path."""
    torch.cuda.synchronize()
    t_build = time.perf_counter()
    env = BatchedMinerEnv(ETHPoWParameters(**MINER_PARAMS), n_replicas=MINER_REPLICAS,
                          decision_ms=MINER_DECISION_MS)
    obs = env.reset()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_build

    def run():
        o, iterations = obs, 0
        for _ in range(MINER_STEPS):
            o, _, info = env.step(miner_policy(o))
            iterations += env.net.jump_stats["iterations"]
        return o, info, iterations

    (obs, info, iterations), wall, steps, launches, window = _windowed_calls(
        env, "step", run, "miner_env_profile", PROFILE_FROM, MINER_PROFILE_STEPS)
    wall = _scaled(wall, steps, MINER_PROFILE_STEPS, window)
    r0 = {k: v[0].item() for k, v in obs.items()}
    out = {"phase": "miner_env", "replicas": MINER_REPLICAS, "steps": steps,
           "decision_ms": MINER_DECISION_MS, "build_s": build_s, "wall_s": wall,
           "ms_per_step": wall / steps * 1e3, "loop_iterations": iterations,
           "sims_per_s": MINER_REPLICAS / wall,
           "kernels_per_step": window["kernels_per_iteration"],
           "device_ms_per_step": window["device_ms_per_iteration"],
           "device_busy_share": window["device_busy_share"],
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "reward_ratio_p10_p50_p90": _percentiles(obs["reward_ratio"]),
           "overflowed": int(info["overflowed"].sum()), "launches": launches, "replica0": r0}
    emit(out)
    emit(window)
    if out["overflowed"]:
        raise AssertionError(f"miner_env: {out['overflowed']} blocks overflowed")
    if any(launches.values()):
        raise AssertionError(f"miner_env: its path launched kernels: {launches}")
    _check_replica0("miner_env", r0, MINER_R0)
    return out


def faults_pingpong(plain) -> dict:
    """PingPong at PP_NODES nodes, R = PP_REPLICAS, PP_MS with
    stop_when_done on the 512-row wheel, the first half of the replicas
    under `all_lanes_plan` and the second half neutral (one lower_plans
    stack), with fpp_profile inside the run: every neutral replica equals
    the plain pingpong phase's state for its seed (`plain`, that phase's
    final states), replica 0 equals the JAX package's seed-0 run (FPP_R0),
    the fault counters are nonzero and the occupancy kernels launch."""
    t_build = time.perf_counter()
    net, state = make_pingpong(PP_NODES)
    half = PP_REPLICAS // 2
    plan = all_lanes_plan(PP_NODES)
    fs = lower_plans([plan] * half + [None] * (PP_REPLICAS - half), PP_NODES,
                     net.protocol.n_msg_types())
    fnet, states = net.with_faults(replicate_state(state, PP_REPLICAS), FaultConfig(), fs)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_build
    states, wall, launches, window = _windowed_jumps(fnet, states, PP_MS, True, "fpp_profile")
    f = states.faults
    s0 = {"pong": int(states.proto["pong"][0, 0]),
          "msg_received": int(states.msg_received[0].sum()),
          "msg_sent": int(states.msg_sent[0].sum()), "done_at_sum": int(states.done_at[0].sum()),
          "dropped_by_fault": f.dropped_by_fault[0].tolist(),
          "delayed_by_fault": f.delayed_by_fault[0].tolist(),
          "pending": int(states.ovf_valid[0].sum() + states.msg_valid[0].sum()),
          "time": int(states.time[0])}
    differ = [] if plain is None else _differing_leaves(states, plain, slice(half, None))
    out = {**_jump_row("faults_pingpong", fnet, PP_REPLICAS, build_s, wall, launches, window,
                       states),
           "ms": PP_MS, "replica0": s0,
           "dropped_by_fault": int(f.dropped_by_fault.sum()),
           "delayed_by_fault": int(f.delayed_by_fault.sum()),
           "neutral_fault_counts": int(f.dropped_by_fault[half:].sum()
                                       + f.delayed_by_fault[half:].sum()),
           "neutral_equal_plain": None if plain is None else not differ,
           "pong_faulted_p10_p50_p90": _percentiles(
               states.proto["pong"][:half, 0].cpu().numpy())}
    emit(out)
    emit(window)
    if differ:
        raise AssertionError(f"faults_pingpong: neutral replicas differ from plain in {differ}")
    if out["neutral_fault_counts"]:
        raise AssertionError("faults_pingpong: a neutral replica counted a fault")
    if not (out["dropped_by_fault"] and out["delayed_by_fault"]):
        raise AssertionError("faults_pingpong: a fault counter stayed 0")
    for name in ("pack_occupied", "lowest_set_bit", "popcount_words"):
        if launches[name] <= 0:
            raise AssertionError(f"faults_pingpong: {name} kernel never launched")
    _check_replica0("faults_pingpong", s0, FPP_R0)
    return out


def attack_env(flag_done) -> dict:
    """BatchedAttackEnv on the flagship: make_handel(flagship_params(4096)),
    R = ATTACK_REPLICAS, ATTACK_HORIZON_MS in ATTACK_DECISION_MS steps,
    replicas 0-7 silent on every step and 8-15 never, with a 10-tick
    attack_profile window from tick ATTACK_PROFILE_FROM: the never-silent
    replicas' done_at equals the flagship phase's for the same seeds
    (`flag_done`) on every node done before the horizon and is 0 on the
    others (done_at is the tick of completion), some of their nodes are
    done, the silent replicas' undone share is not below the others',
    and the popcount family launches in this run."""
    torch.cuda.synchronize()
    t_build = time.perf_counter()
    net, state = make_handel(flagship_params(FLAGSHIP_NODES))
    env = BatchedAttackEnv(net, state, n_replicas=ATTACK_REPLICAS,
                           decision_ms=ATTACK_DECISION_MS, horizon_ms=ATTACK_HORIZON_MS)
    obs = env.reset()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_build
    acts = np.arange(ATTACK_REPLICAS) < ATTACK_SILENT
    steps = ATTACK_HORIZON_MS // ATTACK_DECISION_MS

    def run():
        o = obs
        for _ in range(steps):
            o, _, _ = env.step(acts)
        return o

    obs, wall, ticks, launches, window = _windowed_calls(
        env.net, "_step_core", run, "attack_profile", ATTACK_PROFILE_FROM,
        LOCKSTEP_PROFILE_TICKS)
    wall = _scaled(wall, ticks, LOCKSTEP_PROFILE_TICKS, window)
    done = env.states.done_at.cpu().numpy()
    undone = obs["undone_frac"]
    f = env.states.faults
    out = {"phase": "attack_env", "nodes": FLAGSHIP_NODES, "replicas": ATTACK_REPLICAS,
           "silent_replicas": ATTACK_SILENT, "silent_nodes": int(len(env.silent_nodes)),
           "build_s": build_s, "ticks": ticks, "wall_s": wall, "ms_per_tick": wall / ticks * 1e3,
           "sims_per_s": ATTACK_REPLICAS / wall,
           "kernels_per_tick": window["kernels_per_iteration"],
           "device_ms_per_tick": window["device_ms_per_iteration"],
           "device_busy_share": window["device_busy_share"],
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "undone_silent": undone[:ATTACK_SILENT].tolist(),
           "undone_honest": undone[ATTACK_SILENT:].tolist(),
           "dropped_by_fault_silent": int(f.dropped_by_fault[:ATTACK_SILENT].sum()),
           "dropped_by_fault_honest": int(f.dropped_by_fault[ATTACK_SILENT:].sum()),
           "honest_done_equal_flagship": None if flag_done is None else bool(
               np.array_equal(done[ATTACK_SILENT:], np.where(
                   flag_done[ATTACK_SILENT:] < ticks, flag_done[ATTACK_SILENT:], 0))),
           "honest_done_share": float((done[ATTACK_SILENT:] > 0).mean()),
           "launches": launches,
           "launches_per_tick": {k: v / ticks for k, v in launches.items()}}
    emit(out)
    emit(window)
    if out["honest_done_equal_flagship"] is False:
        raise AssertionError("attack_env: a never-silent replica's done_at differs from the "
                             "flagship's")
    if not out["honest_done_share"] > 0:
        raise AssertionError("attack_env: no never-silent node is done by the horizon")
    if out["dropped_by_fault_honest"] or not out["dropped_by_fault_silent"]:
        raise AssertionError("attack_env: silence acted where it should not, or nowhere")
    if undone[:ATTACK_SILENT].min() < undone[ATTACK_SILENT:].max():
        raise AssertionError(f"attack_env: a silent replica's undone share is below an "
                             f"honest one's: {undone.tolist()}")
    for name in ("popcount_words", "popcount_binop", "cand_score"):
        if launches[name] <= 0:
            raise AssertionError(f"attack_env: {name} kernel never launched")
    return out


def casper_replica0(states) -> dict:
    """Replica 0's outcome in the numbers the JAX package's seed-0 run
    gives (CASPER_R0)."""
    p = states.proto
    heights = torch.nonzero(p["blk_exists"][0])[:, 0]
    ov = states.ovf_valid[0]
    live = torch.nonzero(ov)[:, 0]
    return {
        "heights": heights.tolist(),
        "blk_parent": p["blk_parent"][0, heights].tolist(),
        "blk_time": p["blk_time"][0, heights].tolist(),
        "head_min": int(p["head"][0].min()), "head_max": int(p["head"][0].max()),
        "msg_received": int(states.msg_received[0].sum()),
        "msg_sent": int(states.msg_sent[0].sum()), "msg_head": int(states.msg_head[0]),
        "att_exists": int(p["att_exists"][0].sum()), "rec_att": int(p["rec_att"][0].sum()),
        "reeval": int(p["reeval"][0].sum()), "wf_on_time": int(p["wf_on_time"][0].sum()),
        "wf_late": int(p["wf_late"][0].sum()), "overflow_live": int(ov.sum()),
        "overflow_slots": [int(live.min()), int(live.max())] if live.numel() else [],
        "overflow_types": torch.bincount(states.ovf_type[0][ov].long(), minlength=7).tolist(),
        "overflow_arrival_sum": int(states.ovf_arrival[0][ov].long().sum()),
    }


def casper() -> dict:
    """BASELINE config 4: make_casper(CasperParameters(cycle_length=4,
    attesters_per_round=256, ...), max_heights=12) at 1027 nodes,
    replicate_state(CASPER_REPLICAS), run_ms_batched(48000), once per
    latency model of the sweep, each with its CASPER_WINDOWS profiled
    window inside the run.  Its path launches no hand-written kernel (the
    flat store reads no wheel occupancy)."""
    out = {}
    for model, kw in CASPER_MODELS.items():
        t_build = time.perf_counter()
        net, state = make_casper(CasperParameters(cycle_length=4, attesters_per_round=256, **kw),
                                 max_heights=CASPER_HEIGHTS)
        states = replicate_state(state, CASPER_REPLICAS)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t_build
        start, per = CASPER_WINDOWS[model]
        states, wall, launches, window = _windowed_jumps(
            net, states, CASPER_MS, False, f"casper_{model}_profile", start, per)
        p = states.proto
        exists = p["blk_exists"]
        chain = (p["blk_parent"] == net.protocol.hr - 1) | ~exists
        r0 = casper_replica0(states)
        row = {**_jump_row("casper", net, CASPER_REPLICAS, build_s, wall, launches, window,
                           states),
               "model": model, "max_heights": CASPER_HEIGHTS, "ms": CASPER_MS,
               "blocks_per_replica_min": int(exists.sum(-1).min()) - 1, "replica0": r0}
        emit(row)
        emit(window)
        if row["dropped"]:
            raise AssertionError(f"casper {model}: {row['dropped']} messages dropped")
        if not (chain[:, 1:].all() and (exists.sum(-1) >= 5).all()):
            raise AssertionError(f"casper {model}: a replica's chain is forked or short: "
                                 f"{p['blk_parent'][~chain.all(-1)][:3].tolist()}")
        if r0 != CASPER_R0:
            raise AssertionError(f"casper {model}: replica 0 gives {r0}, the JAX package "
                                 f"{CASPER_R0}")
        out[model] = row
    total = sum(r["wall_s"] for r in out.values())
    emit({"phase": "casper_sweep", "wall_s": total,
          "sims_per_s": {m: r["sims_per_s"] for m, r in out.items()}})
    return {**out["distance"], "models": out}


def paxos() -> dict:
    """make_paxos(PaxosParameters()) on the 512-row wheel,
    replicate_state(PAXOS_REPLICAS), run_ms_batched(5000,
    stop_when_done=True) with paxos_profile inside it: no replica's
    proposers accept two values or one nobody proposed, every replica
    decides but the seeds the JAX package leaves undecided
    (PAXOS_UNDECIDED), replica 0 gives the JAX package's seed-0 run,
    nothing drops, and the occupancy kernels launch.  The run's numbers
    are printed before the checks fail."""
    t_build = time.perf_counter()
    net, state = make_paxos(PaxosParameters())
    states = replicate_state(state, PAXOS_REPLICAS)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_build
    states, wall, launches, window = _windowed_jumps(net, states, PAXOS_MS, True,
                                                     "paxos_profile")
    prop = net.protocol.prop_ids.long()
    val = states.proto["value_accepted"][:, prop]
    done = states.done_at[:, prop].cpu().numpy()
    undecided = (val < 0).any(-1)
    split = ~undecided & ((val != val[:, :1]).any(-1)
                          | ~torch.isin(val[:, 0], net.protocol.value_proposed[prop]))
    r0 = {"done_at": done[0].tolist(), "value": int(val[0, 0]),
          "msg_received": int(states.msg_received[0].sum()),
          "msg_sent": int(states.msg_sent[0].sum())}
    fin = done[done > 0]
    q = np.percentile(fin, [10, 50, 90]).tolist()
    out = {**_jump_row("paxos", net, PAXOS_REPLICAS, build_s, wall, launches, window, states),
           "ms": PAXOS_MS, "done_at_p10": q[0], "done_at_p50": q[1], "done_at_p90": q[2],
           "done_at_max": int(fin.max()), "replica0": r0,
           "undecided_seeds": torch.nonzero(undecided)[:, 0].tolist(),
           "split_seeds": torch.nonzero(split)[:, 0].tolist()}
    emit(out)
    emit(window)
    want = {"done_at": [487, 912, 226], "value": 95, "msg_received": 77, "msg_sent": 78}
    if r0 != want:
        raise AssertionError(f"paxos: replica 0 gives {r0}, the JAX package {want}")
    if out["split_seeds"]:
        raise AssertionError(f"paxos: replicas whose proposers accepted two values or an "
                             f"unproposed one: {out['split_seeds'][:20]}")
    expected = [seed for seed in PAXOS_UNDECIDED if seed < PAXOS_REPLICAS]
    if out["undecided_seeds"] != expected:
        raise AssertionError(f"paxos: undecided replicas {out['undecided_seeds'][:20]}, the JAX "
                             f"package's {expected}")
    if out["dropped"]:
        raise AssertionError(f"paxos: {out['dropped']} messages dropped")
    for name in ("pack_occupied", "lowest_set_bit", "popcount_words"):
        if launches[name] <= 0:
            raise AssertionError(f"paxos: {name} kernel never launched")
    return out


PHASES = ("kernels", "identity", "flagship", "telemetry", "sweep", "cities", "search", "pingpong",
          "faults_pingpong", "pingpong_tele", "dfinity", "gsf", "p2phandel", "handeleth2",
          "sanfermin", "casper", "paxos", "slush", "snowflake", "p2pflood", "optimistic",
          "cappos", "enr", "ethpow", "miner_env", "attack_env", "durable")


@torch.inference_mode()
def main(argv) -> int:
    # `--phases a,b` runs a subset (for development); the default runs every
    # phase and ends with the kernels line
    only = set(argv[argv.index("--phases") + 1].split(",")) if "--phases" in argv else None
    if only is not None and not only <= set(PHASES):
        raise SystemExit(f"chip_smoke: --phases takes some of {','.join(PHASES)}")

    def want(name: str) -> bool:
        return only is None or name in only

    info = device_info()
    t_last, seconds = [time.perf_counter()], {}

    def lap(name: str) -> None:
        now = time.perf_counter()
        seconds[name] = now - t_last[0]
        t_last[0] = now

    build()
    lap("build")
    runs = {}
    if want("kernels"):
        rows = run_kernels()
        agg = aggregation_kernels(torch.Generator(device="cuda").manual_seed(2))
        eth2 = eth2_kernels(torch.Generator(device="cuda").manual_seed(3))
        pax = paxos_kernels(torch.Generator().manual_seed(4))
        lap("kernels")
    if want("identity"):
        identity()
        lap("identity")
    flag_done = flag = None
    if want("flagship"):
        runs["flagship"] = flag = flagship()
        flag_done = flag.pop("_done_at")
        lap("flagship")
    if want("telemetry"):
        runs["telemetry"] = telemetry(flag)
        lap("telemetry")
    if flag is not None:
        del flag["_states"]
    if want("sweep") or want("cities") or want("search"):
        runs.update(sweeps(want("sweep"), want("cities"), want("search")))
        if "sweep" in runs:
            # the profiled group's eligibility rows at its window's first tick
            real = [(a.cuda(), b.cuda()) for a, b in runs["sweep"].pop("_real")]
            lowest_rows, andnot_rows = lowest_bucket_times(real), andnot_bucket_times(real)
            emit({"phase": "byz_rows", "lowest_set_bit": lowest_rows,
                  "lowest_set_bit_andnot": andnot_rows})
        lap("sweep")
    pp_states = None
    if want("pingpong"):
        runs["pingpong"] = pp = pingpong()
        pp_states = pp.pop("_states")
        lap("pingpong")
    if want("faults_pingpong"):
        runs["faults_pingpong"] = faults_pingpong(pp_states)
        lap("faults_pingpong")
    if want("pingpong_tele"):
        runs["pingpong_tele"] = pingpong_tele(runs.get("pingpong"), pp_states)
        lap("pingpong_tele")
    del pp_states
    # the durable phase's three processes run beside the phases from
    # dfinity on, and are joined after the last
    chain = _DurableChain().start() if want("durable") else None
    if want("dfinity"):
        runs["dfinity"] = dfinity()
        lap("dfinity")
    if want("gsf"):
        runs["gsf"] = gsf()
        lap("gsf")
    if want("p2phandel"):
        runs["p2phandel"] = p2phandel()
        lap("p2phandel")
    for path, run in (("handeleth2", handeleth2), ("sanfermin", sanfermin), ("casper", casper),
                      ("paxos", paxos), ("slush", lambda: avalanche("slush")),
                      ("snowflake", lambda: avalanche("snowflake")), ("p2pflood", p2pflood),
                      ("optimistic", optimistic), ("cappos", cappos), ("enr", enr),
                      ("ethpow", ethpow), ("miner_env", miner_env),
                      ("attack_env", lambda: attack_env(flag_done))):
        if want(path):
            runs[path] = run()
            lap(path)
    if chain is not None:
        runs["durable"] = chain.join()
        lap("durable")  # the wait for the chain after the last phase
    emit({"phase": "phase_seconds", **seconds, "total": sum(seconds.values()),
          "durable_beside": None if chain is None else chain.seconds})
    # every path's launches of every form, from that path's own run
    emit({"phase": "launches_by_path",
          **{path: out["launches"] for path, out in runs.items()}})
    if only is None:
        rows["lowest_set_bit_andnot"].update(andnot_rows[-1])  # the top bucket's rows
        # pack_bool_words' path is P2PHandel's _pack: its numbers at the
        # verified rows [R*N, 120] replace the wheel shape's
        rows["pack_bool_words"].update(agg["rows"]["pack_bool_words"][0])
        for name in ("popcount_binop", "cand_score", "lowest_set_bit", "pack_bool_words"):
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], agg["errs"][name])
        for name, err in eth2["errs"].items():
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
        for name, row in pax.items():
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], row["max_abs_err"])
        # launches: each kernel's count from the run of its path — the
        # popcount family from the flagship, lowest_set_bit_andnot from
        # the Byzantine sweep (the flagship runs no attack), lowest_set_bit
        # and pack_occupied from the PingPong run, pack_bool_words from
        # the P2PHandel run
        for name in ("popcount_words", "popcount_binop", "cand_score"):
            rows[name]["launches"] = flag["launches"][name]
        rows["lowest_set_bit_andnot"]["launches"] = \
            runs["sweep"]["launches"]["lowest_set_bit_andnot"]
        for name in ("lowest_set_bit", "pack_occupied"):
            rows[name]["launches"] = pp["launches"][name]
        rows["pack_bool_words"]["launches"] = runs["p2phandel"]["launches"]["pack_bool_words"]
        keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms")
        # beside the main path's count, each path's own (HandelEth2's,
        # SanFermin's, Casper's — none — Paxos's and ENR's — none — among them)
        emit({"kernels": [
            {**{k: r[k] for k in keys},
             "launches_by_path": {path: out["launches"][r["name"]] for path, out in runs.items()}}
            for r in rows.values()
        ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    if "--durable-child" in sys.argv:
        i = sys.argv.index("--durable-child")
        sys.exit(durable_child(sys.argv[i + 1], sys.argv[i + 2]))
    sys.exit(main(sys.argv[1:]))
