"""The message-store protocols on the port's mesh against the JAX
package's unsharded run: PingPong (time wheel, consensus jumps) and
P2PFlood (flat store) at their registry scale, R = 8, 120 ms
(test_mesh2d.py's SIM_MS), placed on (2, 4) and (4, 2) over eight CPU
devices, every leaf equal to the JAX package's `run_ms_batched` of the
same states; the placed run's `jump_stats` equal the unsharded port's.
And the node-axis spike: `pingpong_progression(1024, ...)` over an
8-block mesh equals the JAX package's, and 100 nodes over 8 blocks are
refused.
"""

import numpy as np
import pytest

from test_torch_telemetry import assert_same_state, jax_numpy
from wittgenstein_tpu.core.registries import registry_batched_protocols as jreg
from wittgenstein_tpu.engine import replicate_state as jrep
from wittgenstein_tpu.parallel import mesh2d as jm
from wittgenstein_tpu.parallel import node_shard as jns
from wittgenstein_tpu_torch.core.registries import registry_batched_protocols as treg
from wittgenstein_tpu_torch.engine import replicate_state
from wittgenstein_tpu_torch.interop import state_to_numpy
from wittgenstein_tpu_torch.parallel import mesh2d as tm
from wittgenstein_tpu_torch.parallel import node_shard as tns

R = 8
SIM_MS = 120
CPU8 = ["cpu"] * 8
_JAX = {}


def _jax_ref(name):
    """The JAX package's unsharded run, once per protocol."""
    if name not in _JAX:
        jnet, jstate = jreg.get(name).factory()
        _JAX[name] = jax_numpy(jnet.run_ms_batched(jrep(jstate, R), SIM_MS))
    return _JAX[name]


@pytest.mark.parametrize("name", ["pingpong", "p2pflood"])
@pytest.mark.parametrize("p_r,p_n", [(2, 4), (4, 2)])
def test_placed_run_equals_jax_unsharded(name, p_r, p_n):
    net, state = treg.get(name).factory(device="cpu")
    states = replicate_state(state, R)
    placed = tm.make_mesh2d_layout(p_r, p_n, CPU8).place(net, states)
    out = net.run_ms_batched(placed, SIM_MS)
    assert isinstance(out, tm.PlacedState)
    assert out.cells[0][0].down.shape == (R // p_r, net.n_nodes // p_n)
    stats = net.jump_stats
    assert_same_state(_jax_ref(name), state_to_numpy(out), f"{name} ({p_r},{p_n})")
    net.run_ms_batched(states, SIM_MS)
    assert stats["iterations"] == net.jump_stats["iterations"]
    for k in ("last_tick", "ticks"):
        assert np.array_equal(stats[k].numpy(), net.jump_stats[k].numpy()), k


def test_pingpong_progression_over_blocks_equals_jax():
    qts = [50, 100, 200, 400, 800]
    want = np.asarray(jns.pingpong_progression(1024, qts, mesh=jm.make_mesh2d(1, 8),
                                               axis="nodes"))
    mesh = tm.make_mesh2d(1, 8, CPU8)
    got = tns.pingpong_progression(1024, qts, mesh=mesh, axis="nodes")
    assert got.dtype.is_floating_point is False
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(tns.pingpong_progression(1024, qts, device="cpu").numpy(), want)
    with pytest.raises(ValueError, match="not divisible"):
        tns.pingpong_progression(100, qts, mesh=mesh, axis="nodes")
