"""Batched PingPong in the port against the JAX package, leaf for leaf.

PingPong is the event-driven main path: the 512-row time wheel, the
occupancy summaries (pack_bool_words with lowest_set_bit and
popcount_words, their plain versions on the CPU) and the consensus-jump
loop.  The JAX package runs as its own tests run it on the CPU, through
both of its loops for event-driven protocols — the default vmapped
per-replica loop and the consensus-jump loop of `with_batched_jumps(True)`,
which it pins bit-identical to each other.  Every leaf is integer or bool,
so every comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wittgenstein_tpu.engine import replicate_state as jreplicate
from wittgenstein_tpu.engine import stack_states as jstack
from wittgenstein_tpu.protocols.pingpong_batched import make_pingpong as jmake
from wittgenstein_tpu_torch.engine import map_state
from wittgenstein_tpu_torch.engine import replicate_state as treplicate
from wittgenstein_tpu_torch.engine import stack_states as tstack
from wittgenstein_tpu_torch.interop import state_from_numpy, state_to_numpy
from wittgenstein_tpu_torch.protocols.pingpong_batched import make_pingpong as tmake

N = 1000
REPLICAS = 2
SIM_MS = 700


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def jax_numpy(state) -> dict:
    d = jax.tree_util.tree_map(np.asarray, state)._asdict()
    d["proto"] = dict(d["proto"])
    return d


def assert_same_state(want: dict, got: dict, tag: str) -> None:
    """Every leaf equal in name, dtype, shape and bits."""
    assert set(want) == set(got), tag
    for f, w in want.items():
        g = got[f]
        if f == "proto":
            assert set(w) == set(g), f"{tag}: proto keys"
            for k in w:
                assert w[k].dtype == g[k].dtype and w[k].shape == g[k].shape, f"{tag}: proto.{k}"
                assert np.array_equal(w[k], g[k]), f"{tag}: proto.{k} differs"
        elif isinstance(w, np.ndarray):
            assert w.dtype == g.dtype and w.shape == g.shape, f"{tag}: {f} dtype/shape"
            assert np.array_equal(w, g), f"{tag}: {f} differs"
        else:
            assert g == w == (), f"{tag}: side-car {f}"


@pytest.fixture(scope="module")
def at_1000():
    """The JAX reference at 1000 nodes x 2 replicas x 700 ms with
    stop_when_done, through both of its loops."""
    jnet, jstate = jmake(N)
    js = jreplicate(jstate, REPLICAS)
    default = jax_numpy(jnet.run_ms_batched(js, SIM_MS, stop_when_done=True))
    jumps = jax_numpy(
        jnet.with_batched_jumps(True).run_ms_batched(js, SIM_MS, stop_when_done=True)
    )
    return jstate, default, jumps


def test_initial_state_matches(at_1000):
    jstate, _, _ = at_1000
    _, tstate = tmake(N, device="cpu")
    want = jax_numpy(jreplicate(jstate, 1))
    assert_same_state(want, state_to_numpy(treplicate(tstate, 1)), "initial state")
    assert want["msg_valid"].shape == (1, 512, 64)  # W=512, B=64
    assert want["ovf_valid"].shape == (1, 258)  # capped V = capacity // 8


def test_run_matches_both_jax_loops(at_1000):
    _, default, jumps = at_1000
    tnet, tstate = tmake(N, device="cpu")
    out = state_to_numpy(tnet.run_ms_batched(treplicate(tstate, REPLICAS), SIM_MS, True))
    assert_same_state(default, out, "against the default loop")
    assert_same_state(jumps, out, "against the consensus-jump loop")
    assert (out["proto"]["pong"][:, 0] == N).all()  # every witness done
    assert (out["dropped"] == 0).all()
    assert (out["time"] == SIM_MS).all()


def test_flat_store_matches_wheel():
    """The flat store (wheel_rows=0) is the wheel's parity reference: the
    same seed gives the same pongs, traffic counters, RNG stream and drops
    (tests/test_timewheel.py pins the same in the JAX package)."""
    net_w, s_w = tmake(300, seed=3, device="cpu")
    net_f, s_f = tmake(300, seed=3, wheel_rows=0, device="cpu")
    assert not net_w.flat and net_f.flat
    s_w, s_f = treplicate(s_w, REPLICAS), treplicate(s_f, REPLICAS)
    for ms in (1, 300, 300):
        s_w = net_w.run_ms(s_w, ms)
        s_f = net_f.run_ms(s_f, ms)
    assert (s_w.proto["pong"][:, 0] == 300).all()
    for f in ("msg_received", "msg_sent", "bytes_received", "send_ctr", "dropped", "time"):
        assert torch.equal(getattr(s_w, f), getattr(s_f, f)), f
    assert torch.equal(s_w.proto["pong"], s_f.proto["pong"])
    assert (s_w.dropped == 0).all()


def _warmed_lanes_torch(net, state, warms):
    lanes = []
    for i, warm in enumerate(warms):
        s = treplicate(state, 1, seeds=[100 + i])
        if warm:
            s = net.run_ms(s, warm)
        lanes.append(map_state(lambda a: a[0], s))
    return tstack(lanes)


def test_heterogeneous_clocks():
    """Stacked replicas warmed 0, 37 and 81 ms: the clocks differ, the
    consensus tick walks the union of their tick sets and each replica
    keeps its own stream (test_batched_jumps.py's case in the JAX
    package)."""
    warms = (0, 37, 81)
    jnet, jstate = jmake(64)
    lanes = []
    for i, warm in enumerate(warms):
        s = jstate._replace(seed=jnp.int32(100 + i))
        if warm:
            s = jnet.run_ms(s, warm)
        lanes.append(s)
    js = jstack(lanes)
    tnet, tstate = tmake(64, device="cpu")
    ts = _warmed_lanes_torch(tnet, tstate, warms)
    assert_same_state(jax_numpy(js), state_to_numpy(ts), "warmed")
    assert len(set(ts.time.tolist())) == 3
    want = jax_numpy(jnet.run_ms_batched(js, 90))
    assert_same_state(want, jax_numpy(jnet.with_batched_jumps(True).run_ms_batched(js, 90)),
                      "the JAX package's two loops")
    assert_same_state(want, state_to_numpy(tnet.run_ms_batched(ts, 90)), "after 90 ms")


def test_interop_handover():
    """The JAX package runs 100 ms, the port takes its state over, and
    both run 200 ms more."""
    jnet, jstate = jmake(N)
    js = jnet.run_ms_batched(jreplicate(jstate, REPLICAS), 100)
    tnet, _ = tmake(N, device="cpu")
    ts = state_from_numpy(jax_numpy(js), "cpu")
    assert_same_state(jax_numpy(js), state_to_numpy(ts), "handover")
    js = jnet.run_ms_batched(js, 200)
    ts = tnet.run_ms_batched(ts, 200)
    assert_same_state(jax_numpy(js), state_to_numpy(ts), "after the handover")
