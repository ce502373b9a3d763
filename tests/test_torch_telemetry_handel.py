"""The telemetry side-car on Handel in the port against the JAX package.

Handel's messages travel in its own channel (_agg_batched), which every
send reaches through the engine's latency path: the store counters stay
0 and the traffic shows in `lat_sent`.  Flagship-shaped Handel at 64
nodes x 2 replicas runs with telemetry and a snapshot ring on the flat
store and on the 512-row wheel, and the flat run again on a batch whose
clocks differ (7, 0 and 7 ms, test_torch_clocks.py); every `tele` leaf
equals the JAX package's, every other leaf the telemetry-off run's, and
the ring's done counts the host-side CDF of done_at.
"""

import numpy as np
import pytest
import torch

from test_torch_clocks import mixed_clocks, to_jax
from test_torch_telemetry import assert_reconciles, assert_same_state, jax_numpy
from wittgenstein_tpu.engine import replicate_state as jreplicate
from wittgenstein_tpu.protocols.handel import HandelParameters as JParams
from wittgenstein_tpu.protocols.handel_batched import make_handel as jmake
from wittgenstein_tpu.telemetry import TelemetryConfig as JConfig
from wittgenstein_tpu_torch.engine import replicate_state as treplicate
from wittgenstein_tpu_torch.interop import state_from_numpy, state_to_numpy
from wittgenstein_tpu_torch.protocols.handel import HandelParameters as TParams
from wittgenstein_tpu_torch.protocols.handel_batched import make_handel as tmake
from wittgenstein_tpu_torch.telemetry import TelemetryConfig, done_counts_at, progress_series

PARAMS = dict(node_count=64, threshold=63)
CFG = dict(snapshots=32, snapshot_every_ms=10)
SIM_MS = 300


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


def _build(wheel_rows, telemetry):
    jnet, js = jmake(JParams(**PARAMS), fuse_step=True, score_cache=True, wheel_rows=wheel_rows,
                     telemetry=JConfig(**CFG) if telemetry else None)
    tnet, ts = tmake(TParams(**PARAMS), score_cache=True, wheel_rows=wheel_rows,
                     telemetry=TelemetryConfig(**CFG) if telemetry else None, device="cpu")
    return jnet, js, tnet, ts


def _check(want, got, plain, tag):
    assert_same_state(want, got, tag)
    assert_same_state(plain, got, f"{tag} vs telemetry off", skip=("tele",))
    assert_reconciles(got)
    tele = got["tele"]
    assert (tele["sent"] == 0).all() and (tele["lat_sent"].sum(-1) > 0).all()


@pytest.mark.parametrize("wheel_rows", [0, 512], ids=["flat", "wheel"])
def test_handel_tele_matches_jax(wheel_rows):
    jnet, js, tnet, ts = _build(wheel_rows, True)
    _, _, pnet, ps = _build(wheel_rows, False)
    jout = jnet.run_ms_batched(jreplicate(js, 2), SIM_MS, stop_when_done=True)
    tout = tnet.run_ms_batched(treplicate(ts, 2), SIM_MS, True)
    pout = pnet.run_ms_batched(treplicate(ps, 2), SIM_MS, True)
    got = state_to_numpy(tout)
    _check(jax_numpy(jout), got, state_to_numpy(pout), f"handel wheel_rows={wheel_rows}")
    # the ring's done counts are the host-side CDF of done_at at each
    # snapshot's tick
    for r, series in enumerate(progress_series(tout)):
        times = [row["time"] for row in series]
        done = got["done_at"][r]
        assert done_counts_at(series, times) == [int(((done > 0) & (done <= t)).sum())
                                                  for t in times]
        assert series[-1]["done"] == int((done > 0).sum()) > 0


def test_handel_tele_on_mixed_clocks():
    """The lockstep loop over groups of one clock, telemetry on: every
    replica's tick census and ring follow its own clock."""
    jnet, js, tnet, _ = _build(0, True)
    _, _, pnet, _ = _build(0, False)
    snap = mixed_clocks(jnet, js)
    plain_snap = dict(snap, tele=())
    want = jax_numpy(jnet.run_ms_batched(to_jax(js, snap), 150))
    got = state_to_numpy(tnet.run_ms_batched(state_from_numpy(snap, "cpu"), 150))
    plain = state_to_numpy(pnet.run_ms_batched(state_from_numpy(plain_snap, "cpu"), 150))
    _check(want, got, plain, "handel mixed clocks")
    assert got["tele"]["ticks"].tolist() == [157, 150, 157]
    assert np.array_equal(got["tele"]["snap_time"].max(-1), [156, 149, 156])
