"""Enumerate every float32 argument of a range and hold the port's `exp`
(ETHPoW's thresholds) to XLA's float32 `exp` on the CPU, bit for bit.

    JAX_PLATFORMS=cpu python3 scripts/torch_ethpow_exp_check.py [--lo -20] [--hi -6]

For every binade [2^e, 2^(e+1)) with lo <= e < hi it takes every float32
x of the binade negated (the thresholds' arguments -hp/cand_diff are
negative), and counts the arguments on which `jnp.exp` differs from
`exp_f32` (the port's, `protocols/ethpow_batched.py`), from torch's own
float32 `exp` and from float64 `exp` rounded to float32 (the port's
form before `exp_f32`).  The default range is the port's covered range
EXP_COVERED.  It prints one JSON line; exit status 1 if `exp_f32`
differs anywhere.  A comparison script: it imports both packages.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from wittgenstein_tpu_torch.protocols.ethpow_batched import EXP_COVERED, exp_f32


def binade(e: int) -> np.ndarray:
    """Every float32 in [2^e, 2^(e+1)), negated."""
    lo = np.float32(2.0**e).view(np.int32)
    hi = np.float32(2.0**(e + 1)).view(np.int32)
    return -np.arange(lo, hi, dtype=np.int32).view(np.float32)


def differ(a: np.ndarray, b: np.ndarray) -> int:
    return int((a.view(np.int32) != b.view(np.int32)).sum())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lo", type=int, default=int(math.log2(EXP_COVERED[0])))
    ap.add_argument("--hi", type=int, default=int(math.log2(EXP_COVERED[1])))
    args = ap.parse_args()
    t0 = time.perf_counter()
    rows, total = [], {"args": 0, "exp_f32": 0, "torch_f32": 0, "f64_rounded": 0}
    for e in range(args.lo, args.hi):
        x = binade(e)
        tx = torch.from_numpy(x)
        want = np.asarray(jnp.exp(jnp.asarray(x)))
        row = {"binade": e, "args": int(x.size),
               "exp_f32": differ(exp_f32(tx).numpy(), want),
               "torch_f32": differ(torch.exp(tx).numpy(), want),
               "f64_rounded": differ(torch.exp(tx.double()).float().numpy(), want)}
        rows.append(row)
        for k in total:
            total[k] += row[k]
    out = {"range_neg_x": [2.0**args.lo, 2.0**args.hi], "total": total, "binades": rows,
           "seconds": time.perf_counter() - t0}
    print(json.dumps(out))
    return 1 if total["exp_f32"] else 0


if __name__ == "__main__":
    sys.exit(main())
