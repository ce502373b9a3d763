"""The port's time-wheel store and event-driven loop against the JAX package.

Both packages build the same probe protocol (tests/test_timewheel.py's
delay probe, rebuilt here on each side): every delivery records how late
each message was and how many were delivered.  Messages go in through
explicit arrivals (no latency draw), one replica with its own arrival
list per replica, so the replicas' next arrivals differ and the port's
consensus-jump loop walks the union of their tick sets.  After the insert
and after each run every leaf must agree with the JAX package's vmapped
default loop: the wheel's [W, B] columns, whl_fill, the overflow lane,
msg_head, dropped and the probe's counters.  All leaves are integer or
bool, so every comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wittgenstein_tpu.core.registries import registry_network_latencies as jlat
from wittgenstein_tpu.engine import BatchedNetwork as JNet
from wittgenstein_tpu.engine import BatchedProtocol as JProto
from wittgenstein_tpu.engine import Emission as JEmission
from wittgenstein_tpu.engine import stack_states as jstack
from wittgenstein_tpu_torch.core.registries import registry_network_latencies as tlat
from wittgenstein_tpu_torch.engine import BatchedNetwork as TNet
from wittgenstein_tpu_torch.engine import BatchedProtocol as TProto
from wittgenstein_tpu_torch.engine import Emission as TEmission
from wittgenstein_tpu_torch.engine import replicate_state
from wittgenstein_tpu_torch.interop import state_from_numpy, state_to_numpy

N = 4


class _JProbe(JProto):
    MSG_TYPES = ["EVT"]
    TICK_INTERVAL = None

    def proto_init(self, n):
        return {"max_delay": jnp.int32(-1), "delivered": jnp.int32(0)}

    def deliver(self, net, state, deliver_mask):
        d = jnp.where(deliver_mask, state.time - state.msg_arrival, -1)
        return state._replace(proto={
            "max_delay": jnp.maximum(state.proto["max_delay"], jnp.max(d)),
            "delivered": state.proto["delivered"] + jnp.sum(deliver_mask.astype(jnp.int32)),
        }), []


class _TProbe(TProto):
    MSG_TYPES = ["EVT"]
    TICK_INTERVAL = None

    def proto_init(self, n):
        return {"max_delay": torch.tensor(-1, dtype=torch.int32),
                "delivered": torch.tensor(0, dtype=torch.int32)}

    def deliver(self, net, state, deliver_mask, t):
        d = torch.where(deliver_mask, t - state.msg_arrival, -1)
        return state._replace(proto={
            "max_delay": torch.maximum(state.proto["max_delay"], d.amax(-1)),
            "delivered": state.proto["delivered"] + deliver_mask.sum(-1).to(torch.int32),
        }), []


def _cols(n):
    z = np.zeros(n, np.int32)
    return {"x": z, "y": z, "extra_latency": z}


def _nets(quantum=1, **kw):
    jp, tp = _JProbe(), _TProbe()
    jp.TIME_QUANTUM = tp.TIME_QUANTUM = quantum
    jnet = JNet(jp, jlat.get_by_name(None), N, capacity=256, **kw)
    tnet = TNet(tp, tlat.get_by_name(None), N, capacity=256, device="cpu", **kw)
    return jnet, tnet


def _schedule(jnet, tnet, arrivals):
    """Replica i gets arrivals[i] (all rows the same length), sent at t=0."""
    jstates = []
    for arr in arrivals:
        s = jnet.init_state(_cols(N), seed=0, proto=jnet.protocol.proto_init(N))
        k = len(arr)
        s = jnet.apply_emission(s, JEmission(
            mask=jnp.ones(k, bool), from_idx=jnp.zeros(k, jnp.int32),
            to_idx=jnp.arange(k, dtype=jnp.int32) % N, mtype=0,
            arrival=jnp.asarray(arr, jnp.int32),
        ))
        jstates.append(s)
    ts = tnet.init_state(_cols(N), seed=0, proto=tnet.protocol.proto_init(N))
    ts = replicate_state(ts, len(arrivals), seeds=[0] * len(arrivals))
    arr = torch.tensor(arrivals, dtype=torch.int32)
    k = arr.shape[1]
    ts = tnet.apply_emission(ts, TEmission(
        mask=torch.ones(arr.shape, dtype=torch.bool), from_idx=torch.zeros(k, dtype=torch.int32),
        to_idx=torch.arange(k, dtype=torch.int32) % N, mtype=0, arrival=arr,
    ), 0)
    return jstack(jstates), ts


def _assert_same(js, ts, tag):
    want = jax.tree_util.tree_map(np.asarray, js)._asdict()
    got = state_to_numpy(ts)
    for f, w in want.items():
        if isinstance(w, dict):
            for k in w:
                assert np.array_equal(np.asarray(w[k]), got[f][k]), f"{tag}: proto.{k}"
        elif isinstance(w, np.ndarray):
            g = got[f]
            assert w.dtype == g.dtype and w.shape == g.shape, f"{tag}: {f} dtype/shape"
            assert np.array_equal(w, g), f"{tag}: {f} differs"


def _run_both(jnet, tnet, js, ts, ms_list):
    for ms in ms_list:
        js = jnet.run_ms_batched(js, ms)
        ts = tnet.run_ms_batched(ts, ms)
        _assert_same(js, ts, f"after {ms} ms")
    return js, ts


def _shifted(base, n_rep=2, step=3):
    return [[a + step * i for a in base] for i in range(n_rep)]


def test_same_tick_burst_spills_to_overflow():
    jnet, tnet = _nets(wheel_rows=64, wheel_slots=4, overflow_capacity=16)
    js, ts = _schedule(jnet, tnet, _shifted([10] * 9))
    _assert_same(js, ts, "insert")
    assert (ts.whl_fill.amax(-1) == 4).all() and (ts.ovf_valid.sum(-1) == 5).all()
    want = jax.vmap(jnet.occupancy)(js)
    got = tnet.occupancy(ts)
    for k in ("wheel_fill_max", "overflow_count"):
        assert np.array_equal(np.asarray(want[k]), got[k].numpy()), k
    js, ts = _run_both(jnet, tnet, js, ts, [30])
    assert (ts.proto["delivered"] == 9).all() and (ts.proto["max_delay"] == 0).all()
    assert (ts.dropped == 0).all()


def test_genuine_overflow_counts_dropped():
    jnet, tnet = _nets(wheel_rows=64, wheel_slots=2, overflow_capacity=4)
    js, ts = _schedule(jnet, tnet, _shifted([10] * 9))
    _assert_same(js, ts, "insert")
    assert (ts.dropped == 3).all()  # 2 wheel + 4 overflow fit
    js, ts = _run_both(jnet, tnet, js, ts, [30])
    assert (ts.proto["delivered"] == 6).all()


def test_beyond_horizon_goes_to_overflow_and_delivers():
    jnet, tnet = _nets(wheel_rows=64)
    js, ts = _schedule(jnet, tnet, _shifted([500, 1000, 40]))
    _assert_same(js, ts, "insert")
    assert (ts.ovf_valid.sum(-1) == 2).all() and (ts.whl_fill.sum(-1) == 1).all()
    js, ts = _run_both(jnet, tnet, js, ts, [600, 500])
    assert (ts.proto["delivered"] == 3).all() and (ts.proto["max_delay"] == 0).all()


def test_occupancy_jump_finds_rows_near_the_wrap():
    """Arrivals around the 64-row wrap.  The 64 sits at t + W when it is
    inserted, before the first step: row 0 is visited at t = 0 with the
    entry not yet due, and the exact row clear must keep it (the JAX
    package's unfused step does; its fused one-row fill would lose it)."""
    jnet, tnet = _nets(wheel_rows=64)
    js, ts = _schedule(jnet, tnet, _shifted([2, 63, 64, 65, 127, 128], 3))
    js, ts = _run_both(jnet, tnet, js, ts, [70, 130])
    assert (ts.proto["delivered"] == 6).all() and (ts.proto["max_delay"] == 0).all()


@pytest.mark.parametrize("quantum", [1, 5])
@pytest.mark.parametrize("wheel_rows", [64, 0])
def test_quantum_window_rounds_up_without_skipping(quantum, wheel_rows):
    """Arrivals off the quantum grid over two calls whose ends are off it
    too, a beyond-horizon entry and one just before the end: a quantum q
    delivers everything with delay < q and never skips past `end`."""
    jnet, tnet = _nets(quantum=quantum, wheel_rows=wheel_rows)
    arrivals = [3, 7, 11, 29, 30, 31, 87, 113, 170]
    js, ts = _schedule(jnet, tnet, _shifted(arrivals, step=-1))
    js, ts = _run_both(jnet, tnet, js, ts, [101, 70])
    assert (ts.time == 171).all()
    assert (ts.proto["delivered"] == len(arrivals)).all()
    md = ts.proto["max_delay"]
    assert ((0 <= md) & (md < quantum)).all()
    assert (ts.dropped == 0).all() and (tnet.pending_messages(ts) == 0).all()


def test_pending_messages_and_next_arrival_on_random_occupancy():
    """The occupancy summaries on random whl_fill and overflow lanes, at
    clocks that rotate the bitmap across its wrap (t and t + 1 as the
    jump reads it)."""
    jnet, tnet = _nets(wheel_rows=128, overflow_capacity=16)
    rng = np.random.RandomState(7)
    js, ts = _schedule(jnet, tnet, [[5], [6], [7], [8], [9], [10]])
    snap = state_to_numpy(ts)
    r = len(snap["time"])
    density = np.array([0.0, 0.01, 0.05, 0.3, 1.0, 0.02])
    snap["whl_fill"] = ((rng.rand(r, 128) < density[:, None]) * rng.randint(1, 5, (r, 128))
                        ).astype(np.int32)
    snap["ovf_valid"] = rng.rand(r, 16) < 0.2
    for t in (0, 1, 63, 127, 128, 500, 1023):
        snap["time"] = np.full(r, t, np.int32)
        jstate = jax.tree_util.tree_map(jnp.asarray, js._replace(**{
            k: snap[k] for k in ("time", "whl_fill", "ovf_valid")}))
        tstate = state_from_numpy(snap, "cpu")
        want_next = np.asarray(jax.vmap(jnet._wheel_next_arrival)(jstate))
        got_next = tnet._wheel_next_arrival(tstate, t).numpy()
        assert np.array_equal(want_next, got_next), t
        assert np.array_equal(np.asarray(jax.vmap(jnet.pending_messages)(jstate)),
                              tnet.pending_messages(tstate).numpy())
    assert (got_next == np.iinfo(np.int32).max)[0]  # the empty wheel


def test_quantum_larger_than_wheel_fails_loudly():
    jp = _JProbe()
    jp.TIME_QUANTUM = 128
    jnet = JNet(jp, jlat.get_by_name(None), N, capacity=256, wheel_rows=64)
    js = jnet.init_state(_cols(N), seed=0, proto=jp.proto_init(N))
    with pytest.raises(ValueError, match="TIME_QUANTUM"):
        jnet.run_ms(js, 10)
    with pytest.raises(ValueError, match="TIME_QUANTUM"):
        _nets(quantum=128, wheel_rows=64)
