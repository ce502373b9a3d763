"""Handel with the telemetry side-car on the port's (2, 4) mesh against
the JAX package's unsharded run (R = 8, 120 ms, every leaf, the tele
counters and the progress ring, whose per-node totals are summed over
the node blocks, included).
"""

from test_torch_telemetry import assert_same_state, jax_numpy
from wittgenstein_tpu.core.registries import registry_batched_protocols as jreg
from wittgenstein_tpu.engine import replicate_state as jrep
from wittgenstein_tpu.telemetry.state import TelemetryConfig as JTele
from wittgenstein_tpu_torch.core.registries import registry_batched_protocols as treg
from wittgenstein_tpu_torch.engine import replicate_state
from wittgenstein_tpu_torch.interop import state_to_numpy
from wittgenstein_tpu_torch.parallel import mesh2d as tm
from wittgenstein_tpu_torch.telemetry import TelemetryConfig

R = 8
SIM_MS = 120
CPU8 = ["cpu"] * 8


def test_telemetry_armed_handel_2d_equals_jax_unsharded():
    jnet, jstate = jreg.get("handel").factory()
    jnet, jstate = jnet.with_telemetry(jstate, JTele(snapshots=16, snapshot_every_ms=10))
    want = jax_numpy(jnet.run_ms_batched(jrep(jstate, R), SIM_MS))
    net, state = treg.get("handel").factory(device="cpu")
    net, state = net.with_telemetry(state, TelemetryConfig(snapshots=16, snapshot_every_ms=10))
    placed = tm.make_mesh2d_layout(2, 4, CPU8).place(net, replicate_state(state, R))
    got = state_to_numpy(net.run_ms_batched(placed, SIM_MS))
    assert got["tele"]["snap_sent"].any() and got["tele"]["lat_sent"].any()
    assert_same_state(want, got, "telemetry handel (2,4)")
