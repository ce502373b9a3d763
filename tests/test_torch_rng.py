"""The port's counter RNG against the JAX package, draw for draw.

hash32 (1-4 parts), pseudo_delta and uniform_u01 over 20k int32 draws,
including negatives, INT32_MIN, INT32_MAX and -1; the port computes in
int64 masked to 32 bits where JAX uses uint32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wittgenstein_tpu.engine import rng as jrng
from wittgenstein_tpu_torch.engine import rng as trng

N_DRAWS = 20_000


def _draws(seed):
    rng = np.random.RandomState(seed)
    a = rng.randint(-(2**31), 2**31, size=N_DRAWS, dtype=np.int64).astype(np.int32)
    a[:4] = [-(2**31), 2**31 - 1, -1, 0]
    return a


@pytest.mark.parametrize("n_parts", [1, 2, 3, 4])
def test_hash32_matches(n_parts):
    parts = [_draws(k) for k in range(n_parts)]
    got = trng.hash32(*[torch.from_numpy(p) for p in parts]).numpy()
    want = np.asarray(jrng.hash32(*[jnp.asarray(p) for p in parts]))
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)


def test_hash32_broadcasts_python_ints():
    a = _draws(5)
    got = trng.hash32(7, torch.from_numpy(a), 0xA11CE).numpy()
    want = np.asarray(jrng.hash32(jnp.int32(7), jnp.asarray(a), jnp.int32(0xA11CE)))
    assert np.array_equal(got, want)


def test_pseudo_delta_matches():
    dest, seed = _draws(11), _draws(12)
    got = trng.pseudo_delta(torch.from_numpy(dest), torch.from_numpy(seed)).numpy()
    want = np.asarray(jrng.pseudo_delta(jnp.asarray(dest), jnp.asarray(seed)))
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)
    assert got.min() >= 0 and got.max() <= 99


def test_uniform_u01_matches():
    a, b = _draws(21), _draws(22)
    got = trng.uniform_u01(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jrng.uniform_u01(jnp.asarray(a), jnp.asarray(b)))
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
