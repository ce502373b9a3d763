"""Batches whose replicas' clocks differ, in the port against the JAX package.

The JAX package's loops give each replica its own clock: its lockstep
loop steps every lane at its own time and fires tick_beat when any lane
beats, and its ungated loop vmaps a per-replica while_loop.  The port
splits such a batch into groups of one clock each and steps every group
at its own clock.  A batch with clocks 7, 0 and 7 (replicas 0 and 2
advanced 7 ms from the common start, replica 1 not) runs through
Handel's lockstep loop on the flat store, with and without
stop_when_done (which stops once the whole batch is done, ~340 ms in),
and through `step` and the ungated `run_ms`; every leaf after the run
equals the JAX package's.  test_torch_clocks_wheel.py does the same for
P2PHandel's ungated loop on the 512-row wheel.  Every leaf is integer or
bool, so every comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_telemetry import assert_same_state, jax_numpy
from wittgenstein_tpu.engine import replicate_state as jreplicate
from wittgenstein_tpu.protocols.handel import HandelParameters as JHandelParams
from wittgenstein_tpu.protocols.handel_batched import make_handel as jmake_handel
from wittgenstein_tpu_torch.interop import state_from_numpy, state_to_numpy
from wittgenstein_tpu_torch.protocols.handel import HandelParameters as THandelParams
from wittgenstein_tpu_torch.protocols.handel_batched import make_handel as tmake_handel

CLOCKS = (7, 0, 7)
HANDEL = dict(node_count=64, threshold=63)


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


def mixed_clocks(jnet, jstate, clocks=CLOCKS, base_ms=0):
    """A JAX batch whose replica r (seed r) is at clocks[r]: replicas of a
    common start run base_ms, then those with clock c advanced c ms
    more, as numpy leaves."""
    js = jreplicate(jstate, len(clocks))
    if base_ms:
        js = jnet.run_ms_batched(js, base_ms)
        clocks = tuple(base_ms + c for c in clocks)
    ahead = {c: jax_numpy(jnet.run_ms_batched(js, c - base_ms)) if c > base_ms
             else jax_numpy(js) for c in set(clocks)}

    def pick(*leaves):
        return np.stack([leaves[sorted(ahead).index(c)][r] for r, c in enumerate(clocks)])

    snaps = [ahead[c] for c in sorted(ahead)]
    out = {}
    for f, v in snaps[0].items():
        if isinstance(v, dict):
            out[f] = {k: pick(*[s[f][k] for s in snaps]) for k in v}
        elif isinstance(v, np.ndarray):
            out[f] = pick(*[s[f] for s in snaps])
        else:
            out[f] = v
    assert out["time"].tolist() == list(clocks)
    return out


def to_jax(jstate, snap: dict):
    """A numpy snapshot as the JAX package's SimState (a side-car given as
    a dict takes the type of `jstate`'s)."""
    leaves = {}
    for f, v in snap.items():
        if f in ("tele", "faults") and isinstance(v, dict):
            v = type(getattr(jstate, f))(**v)
        empty = isinstance(v, tuple) and not v
        leaves[f] = v if empty else jax.tree_util.tree_map(jnp.asarray, v)
    return type(jstate)(**leaves)


_BUILT = {}


def handel_flat():
    """Flagship-shaped Handel at 64 nodes on the flat store, both sides,
    and the mixed batch (built once)."""
    if "handel" not in _BUILT:
        jnet, jstate = jmake_handel(JHandelParams(**HANDEL), fuse_step=True, score_cache=True)
        tnet, _ = tmake_handel(THandelParams(**HANDEL), score_cache=True, device="cpu")
        _BUILT["handel"] = (jnet, jstate, tnet, mixed_clocks(jnet, jstate))
    return _BUILT["handel"]


def check_run(built, ms, stop, tag):
    jnet, jstate, tnet, snap = built
    want = jax_numpy(jnet.run_ms_batched(to_jax(jstate, snap), ms, stop_when_done=stop))
    got = state_to_numpy(tnet.run_ms_batched(state_from_numpy(snap, "cpu"), ms, stop))
    assert_same_state(want, got, f"{tag} {ms} ms stop={stop}")
    assert (got["time"] == snap["time"] + ms).all()
    return got


def check_step(built, tag):
    """Three `step`s of the mixed batch against the JAX package's vmapped
    step, then the ungated `run_ms` against its vmapped per-replica loop."""
    jnet, jstate, tnet, snap = built
    js, ts = to_jax(jstate, snap), state_from_numpy(snap, "cpu")
    step = jax.jit(jax.vmap(jnet.step))
    for i in range(3):
        js, ts = step(js), tnet.step(ts)
        assert_same_state(jax_numpy(js), state_to_numpy(ts), f"{tag} step {i}")
    ungated = jax.jit(jax.vmap(lambda s: jnet._run_ms_impl(s, 30, False)))
    assert_same_state(jax_numpy(ungated(js)), state_to_numpy(tnet.run_ms(ts, 30)),
                      f"{tag} run_ms")


def test_handel_lockstep_mixed_clocks():
    check_run(handel_flat(), 60, False, "handel")


def test_handel_lockstep_mixed_clocks_stop_when_done():
    """Every replica finishes by ~340 ms; the loop stops once all have,
    and the clocks still end at their own time + ms."""
    got = check_run(handel_flat(), 400, True, "handel")
    assert (got["done_at"] > 0).all() and got["done_at"].max() < 380


def test_handel_step_on_mixed_clocks():
    check_step(handel_flat(), "handel")


def test_uniform_batch_is_one_group():
    """A batch on one clock is one group: the loops run it whole, as
    before, without gathering its replicas."""
    _, _, tnet, snap = handel_flat()
    ts = state_from_numpy(snap, "cpu")
    groups = tnet._clock_groups(ts)
    assert [(c, idx.tolist()) for c, idx in groups] == [(0, [1]), (7, [0, 2])]
    uniform = ts._replace(time=torch.zeros_like(ts.time))
    assert tnet._clock_groups(uniform) == [(0, None)]
