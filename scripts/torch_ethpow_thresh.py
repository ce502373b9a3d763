"""Count the ETHPoW mining thresholds on which the port and the JAX package
differ, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/torch_ethpow_thresh.py [--ms 600000] [--replicas 16]

The threshold is thresh = 1 - exp(-hashes_per_10ms / cand_diff) in
float32.  The script runs the JAX package's batched ETHPoW (10 miners,
honest and under each strategy at pos 1 with 45%) and collects every
difficulty the runs produce: each mined block's `diff` and the final
candidates' `cand_diff`.  Over those, and over 250 000 more drawn
uniformly across their range, each against every miner's hash power,
it counts how many thresholds differ from `jnp`'s (float32 `exp` on
XLA's CPU) for torch's float32 `exp` and for the port's float64 `exp`
rounded to float32
(`BatchedEthPow.thresholds`), and the largest gap in units of the `exp`
result's ulp (2^-24 in the threshold: one grain of the trial's draw).
It prints one JSON line.  A comparison script: it imports both packages.
"""

from __future__ import annotations

import argparse
import json

import jax.numpy as jnp
import numpy as np
import torch

from wittgenstein_tpu.protocols import ethpow_batched as jeth
from wittgenstein_tpu.protocols.ethpow import ETHPoWParameters as JParams
from wittgenstein_tpu_torch.protocols import ethpow_batched as teth
from wittgenstein_tpu_torch.protocols.ethpow import ETHPoWParameters as TParams

STRATEGIES = (None, "ETHSelfishMiner", "ETHSelfishMiner2", "ETHMinerAgent")


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Gap between two thresholds in ulps of the exp inside (1 - thresh
    recovers the float32 exp exactly)."""
    ea, eb = np.float32(1) - a, np.float32(1) - b
    return np.abs(ea.view(np.int32).astype(np.int64) - eb.view(np.int32).astype(np.int64))


def _params(name):
    kw = {} if name is None else dict(byz_class_name=name, byz_mining_ratio=0.45)
    return dict(number_of_miners=10, **kw)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ms", type=int, default=600_000)
    ap.add_argument("--replicas", type=int, default=16)
    args = ap.parse_args()
    runs = []  # (difficulties, JAX net, port net) per strategy
    for name in STRATEGIES:
        net = jeth.BatchedEthPow(JParams(**_params(name)))
        s = net.run_ms_batched(jeth.replicate_ethpow(net.init_state(), args.replicas), args.ms)
        n, d = np.asarray(s.n_blocks), np.asarray(s.diff)
        cds = np.concatenate([d[r, 1:n[r]] for r in range(args.replicas)]
                             + [np.asarray(s.cand_diff).ravel()])
        runs.append((np.unique(cds.astype(np.float32)), net,
                     teth.BatchedEthPow(TParams(**_params(name)), device="cpu")))
    lo = min(float(r[0].min()) for r in runs)
    hi = max(float(r[0].max()) for r in runs)
    dense = np.random.default_rng(0).uniform(lo, hi, 250_000).astype(np.float32)
    out = {"ms": args.ms, "replicas": args.replicas}
    for tag in ("run", "dense"):
        want, f32, port = [], [], []
        for cds, jnet, tnet in runs:
            cds = dense if tag == "dense" else cds
            cd = np.repeat(cds[:, None], 10, 1)  # every miner's hash power
            hp = np.array(jnet.hp_per_10ms)
            want.append(np.asarray(1.0 - jnp.exp(-jnp.asarray(hp) / jnp.asarray(cd))).ravel())
            f32.append((1.0 - torch.exp(-torch.from_numpy(hp) / torch.from_numpy(cd)))
                       .numpy().ravel())
            port.append(tnet.thresholds(torch.from_numpy(cd)).numpy().ravel())
        want, f32, port = map(np.concatenate, (want, f32, port))
        out[tag] = {
            "thresholds": int(want.size),
            "torch_f32_exp_differ": int((f32 != want).sum()),
            "torch_f32_exp_share": float((f32 != want).mean()),
            "port_f64_exp_differ": int((port != want).sum()),
            "port_f64_exp_share": float((port != want).mean()),
            "max_ulps_torch_f32": int(_ulps(f32, want).max()),
            "max_ulps_port": int(_ulps(port, want).max()),
        }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
