"""The contract checks of the port: each registered batched protocol is
built on a device and its hooks run concretely, so a violation of the
engine's conventions fails in seconds instead of surfacing as a parity
failure in a long campaign.

  * `contracts`          — SL401-SL404, SL406, SL407, SL701, SL901,
                           SL1201 over every registry entry: SimState
                           structure, shape and dtype preservation,
                           store and fault-lane ownership of deliver
                           (same tensor, version unmoved), telemetry and
                           fault neutrality, step determinism, derived
                           caches against recompute_caches, narrow
                           dtypes, jump safety;
  * `rng_audit`          — SL405: how far an on-beat tick_beat advances
                           send_ctr against BEAT_SEND_CALLS;
  * `checkpoint_check`   — SL501: save coverage and bitwise round trips;
  * `serve_check`        — SL801: the scheduler's batching contract;
  * `regressions_check`  — SL1401: the pinned attack regressions;
  * `registry_check`     — SL301: every protocol module registered and
                           tested.

Run: `python -m wittgenstein_tpu_torch.analysis --device cpu` (CUDA by
default).
"""

from .findings import RULES, Finding, Severity  # noqa: F401

__all__ = ["Finding", "RULES", "Severity"]
