"""Handel on the port's mesh against the JAX package's unsharded run:
the registry's Handel (64 nodes), R = 8, 120 ms (test_mesh2d.py's
SIM_MS), placed on (2, 4) and (4, 2) over eight CPU devices — every
leaf equal to the JAX package's `run_ms_batched` of the same states,
the channel arrays 1/8 per cell after the run, and the result's node
columns left as shards of their placed sizes.
"""

import pytest

from test_torch_telemetry import assert_same_state, jax_numpy
from wittgenstein_tpu.core.registries import registry_batched_protocols as jreg
from wittgenstein_tpu.engine import replicate_state as jrep
from wittgenstein_tpu_torch.core.registries import registry_batched_protocols as treg
from wittgenstein_tpu_torch.engine import replicate_state
from wittgenstein_tpu_torch.interop import state_to_numpy
from wittgenstein_tpu_torch.parallel import mesh2d as tm

R = 8
SIM_MS = 120
_JAX = {}


def _jax_ref():
    if "ref" not in _JAX:
        jnet, jstate = jreg.get("handel").factory()
        _JAX["ref"] = jax_numpy(jnet.run_ms_batched(jrep(jstate, R), SIM_MS))
    return _JAX["ref"]


@pytest.mark.parametrize("p_r,p_n", [(2, 4), (4, 2)])
def test_handel_placed_run_equals_jax_unsharded(p_r, p_n):
    net, state = treg.get("handel").factory(device="cpu")
    placed = tm.make_mesh2d_layout(p_r, p_n, ["cpu"] * 8).place(net, replicate_state(state, R))
    out = net.run_ms_batched(placed, SIM_MS)
    for row in out.cells:
        for cell in row:
            assert cell.proto["inc"].shape[:2] == (R // p_r, net.n_nodes // p_n)
    owned = tm.assert_channel_ownership(net, out)
    assert all(per * 8 == total for per, total in owned.values())
    assert_same_state(_jax_ref(), state_to_numpy(out), f"handel ({p_r},{p_n})")
