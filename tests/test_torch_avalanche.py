"""Batched Slush and Snowflake in the port against the JAX package.

Both are event-driven on the 512-row wheel: every jump reads the wheel's
occupancy (pack_occupied and lowest_set_bit, their plain versions on the
CPU) and the quiescence test of `stop_when_done` counts it with
popcount_words.  Each query samples K distinct remotes as `lax.top_k`
over hashed keys, whose tie order (lower index first) decides the order
of the store's rows and so the same-tick adoption races: the port's
`top_k_indices` must give that order, which `torch.topk` does not promise.
Every leaf, the wheel and the overflow lane included, must agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_paxos import assert_same_state, jax_numpy
from wittgenstein_tpu.engine import replicate_state as jreplicate
from wittgenstein_tpu.protocols.avalanche_batched import make_slush as jslush
from wittgenstein_tpu.protocols.avalanche_batched import make_snowflake as jsnowflake
from wittgenstein_tpu.protocols.slush import SlushParameters as JSlush
from wittgenstein_tpu.protocols.snowflake import SnowflakeParameters as JSnowflake
from wittgenstein_tpu_torch.engine import replicate_state as treplicate
from wittgenstein_tpu_torch.interop import state_to_numpy
from wittgenstein_tpu_torch.protocols.avalanche_batched import make_slush as tslush
from wittgenstein_tpu_torch.protocols.avalanche_batched import make_snowflake as tsnowflake
from wittgenstein_tpu_torch.protocols.avalanche_batched import top_k_indices
from wittgenstein_tpu_torch.protocols.slush import SlushParameters as TSlush
from wittgenstein_tpu_torch.protocols.snowflake import SnowflakeParameters as TSnowflake

REPLICAS = 2
# the reference mains: Slush(100, 5, 7, 4/7), Snowflake(100, 5, 7, 4/7, 3)
MAIN = {
    "slush": (jslush, tslush, lambda P: P(100, 5, 7, 4.0 / 7.0)),
    "snowflake": (jsnowflake, tsnowflake, lambda P: P(100, 5, 7, 4.0 / 7.0, 3)),
}
PARAMS = {"slush": (JSlush, TSlush), "snowflake": (JSnowflake, TSnowflake)}
# replica 0 (seed 0) of the JAX package: iter sum, nonce sum, messages
R0 = {"slush": (500, 598, 8400), "snowflake": (400, 458, 6440)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _inference_mode():
    """The port's runs without autograd bookkeeping, as on the card."""
    with torch.inference_mode():
        yield


def _both(mode, params_of=None):
    jmake, tmake, main = MAIN[mode]
    jp, tp = PARAMS[mode]
    params_of = params_of or main
    jnet, jstate = jmake(params_of(jp))
    tnet, tstate = tmake(params_of(tp), device="cpu")
    return jnet, jstate, tnet, tstate


@pytest.mark.parametrize("mode", list(MAIN))
def test_initial_state(mode):
    jnet, jstate, tnet, tstate = _both(mode)
    assert (tnet.wheel_rows, tnet.wheel_slots, tnet.overflow_capacity) == (
        jnet.wheel_rows, jnet.wheel_slots, jnet.overflow_capacity)
    assert_same_state(jax_numpy(jreplicate(jstate, 1)), state_to_numpy(treplicate(tstate, 1)),
                      "initial state")


@pytest.mark.parametrize("mode", list(MAIN))
def test_reference_main_to_quiescence(mode):
    jnet, jstate, tnet, tstate = _both(mode)
    want = jax_numpy(jnet.run_ms_batched(jreplicate(jstate, REPLICAS), 4000,
                                         stop_when_done=True))
    got = state_to_numpy(tnet.run_ms_batched(treplicate(tstate, REPLICAS), 4000, True))
    assert_same_state(want, got, f"{mode} after 4000 ms")
    p = got["proto"]
    assert (p["color"] > 0).all() and not p["active"].any()
    assert (got["dropped"] == 0).all()
    # replica 0: every node red, the JAX package's seed-0 counts
    it, nonce, msgs = R0[mode]
    assert int(p["color"][0].sum()) == 100
    assert (int(p["iter"][0].sum()), int(p["nonce"][0].sum())) == (it, nonce)
    assert int(got["msg_received"][0].sum()) == int(got["msg_sent"][0].sum()) == msgs
    if mode == "snowflake":
        assert (p["iter"] == 4).all()  # everyone exits via cnt > B = 3


@pytest.mark.parametrize("mode", list(MAIN))
def test_defaults_query_until_the_end(mode):
    """The default a = 4.0 makes ak = 28 > k: no flip and no confirming
    majority, so Snowflake's cnt stays 0 and every node keeps querying
    until run_ms ends (tests/test_avalanche_batched.py)."""
    jnet, jstate, tnet, tstate = _both(mode, lambda P: P())
    want = jax_numpy(jnet.run_ms_batched(jreplicate(jstate, REPLICAS), 800))
    got = state_to_numpy(tnet.run_ms_batched(treplicate(tstate, REPLICAS), 800))
    assert_same_state(want, got, f"{mode} defaults after 800 ms")
    assert got["proto"]["active"].all()
    if mode == "snowflake":
        assert (got["proto"]["iter"] == 0).all()


@pytest.mark.parametrize("n, k", [(100, 7), (33, 5), (8, 8)])
def test_sample_order_is_lax_top_k(n, k):
    """The port's sample gives `lax.top_k`'s indices, in its order, on
    int32 key rows with many forced ties (a handful of distinct values,
    the extremes among them) and the self key at INT32_MIN."""
    rng = np.random.RandomState(n)
    rows = 400
    values = np.array([-(2**31), -1, 0, 7, 2**31 - 1], np.int64)
    keys = values[rng.randint(0, len(values), size=(rows, n))].astype(np.int32)
    keys[np.arange(rows), np.arange(rows) % n] = -(2**31)  # the self key
    keys[:50] = rng.randint(-(2**31), 2**31, size=(50, n), dtype=np.int64).astype(np.int32)
    _, want = jax.lax.top_k(jnp.asarray(keys), k)
    got = top_k_indices(torch.from_numpy(keys).reshape(4, rows // 4, n), k)
    assert np.array_equal(got.reshape(rows, k).numpy(), np.asarray(want))
