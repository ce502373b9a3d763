"""wittgenstein_tpu_torch — the PyTorch/CUDA port of wittgenstein_tpu.

The batched simulation engine and its protocols, re-expressed as plain
PyTorch functions on tensors that carry the replica axis R explicitly,
with the JAX package's Pallas bitset kernels rewritten as hand-written
CUDA C++ kernels for Hopper (sm_90a).  The JAX package next door is the
reference: the port takes the same inputs and yields bit-identical state,
leaf for leaf (tests/test_torch_*.py).

Entry points (`protocols.handel_batched.make_handel`,
`protocols.gsf_batched.make_gsf`, `protocols.p2phandel_batched.make_p2phandel`,
`protocols.handeleth2_batched.make_handeleth2`,
`protocols.sanfermin_batched.make_sanfermin`,
`protocols.pingpong_batched.make_pingpong`,
`protocols.dfinity_batched.make_dfinity`,
`protocols.casper_batched.make_casper`, `protocols.paxos_batched.make_paxos`,
`protocols.avalanche_batched.make_slush` and `make_snowflake`,
`protocols.p2pflood_batched.make_p2pflood`,
`protocols.optimistic_p2p_signature_batched.make_optimistic`,
`protocols.sanfermin_cappos_batched.make_sanfermin_cappos`,
`protocols.enr_batched.make_enr`,
`protocols.ethpow_batched.BatchedEthPow`,
`protocols.ethpow_env.BatchedMinerEnv`,
`protocols.handel_env.BatchedAttackEnv`,
`engine.core.BatchedNetwork` with `BatchedNetwork.with_faults` and
`BatchedNetwork.with_telemetry`, and `faults.FaultPlan`'s
`lower`/`lower_plans`)
run on CUDA unless the caller passes `device="cpu"`; without a card they
raise instead of falling back.  On a
CUDA tensor every bitset op launches its kernel; on a CPU tensor it runs
the kernel's plain PyTorch version.

Layout mirrors the JAX package so each module's counterpart is easy to
find:
  utils/      JavaRandom, Pareto distribution, Java integer helpers
  core/       node populations (random, AWS-city and all-cities builders),
              geometry,
              latency models (distance + jitter, AWS regions, IC3,
              fixed, uniform, none), registries
  engine/     SimState, BatchedNetwork (flat store and time wheel, lockstep
              and consensus-jump loops over per-replica clocks, the fault
              lanes and the telemetry counters at send, insert and
              delivery), counter RNG, narrow storage plans
  faults/     FaultPlan (crash, partition, drop, inflate, silence, delay),
              its lowering to the FaultState side-car, digests
  telemetry/  the counter side-car (TelemetryConfig, TelemetryState, the
              snapshot ring), host exports (counters, Prometheus text,
              run records, progress series), SpanTracer, phase timing
  ops/        packed-bitset ops, their CUDA kernels (ops/csrc) and binding
  oracle/     the P2P overlay graph builder (host-side, no DES)
  protocols/  batched Handel and GSF on the bitset-aggregation base;
              P2PHandel, HandelEth2, SanFermin and SanFerminCappos,
              per-ms on the time wheel; PingPong, Dfinity, Paxos, Slush
              and Snowflake on the event-driven path; CasperIMD,
              P2PFlood, OptimisticP2PSignature and ENRGossiping
              event-driven on the flat store; ETHPoW on its own state
              and event loop, with the selfish-mining environment; the
              Handel attack environment on the fault lanes
  data/       the port's own copy of the city tables (names, positions,
              populations)
  interop.py  carry a JAX-package state into the port and back
"""

__version__ = "0.1.0"
