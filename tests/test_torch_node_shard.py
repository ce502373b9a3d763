"""One simulation's nodes over eight blocks: Handel at 64 nodes, one
replica (the JAX package's TestNodeShardedEngine parameters), placed by
`shard_state_by_node` on eight CPU devices and run 400 ms by
`run_ms_node_sharded` — every leaf equal to the JAX package's
`net.run_ms(state, 400)`, and every node array, the channel content
above all, holding 1/8 of its bytes in each block (`node_shard_bytes`).
"""

import numpy as np

from test_torch_telemetry import assert_same_state, jax_numpy
from wittgenstein_tpu.protocols.handel import HandelParameters as JParams
from wittgenstein_tpu.protocols.handel_batched import make_handel as jmake
from wittgenstein_tpu_torch.interop import state_to_numpy
from wittgenstein_tpu_torch.parallel import mesh2d as tm
from wittgenstein_tpu_torch.parallel.node_shard import (
    node_shard_bytes,
    run_ms_node_sharded,
    shard_state_by_node,
)
from wittgenstein_tpu_torch.protocols.handel import HandelParameters as TParams
from wittgenstein_tpu_torch.protocols.handel_batched import make_handel as tmake

P = dict(node_count=64, threshold=60, pairing_time=3, level_wait_time=20, extra_cycle=5,
         dissemination_period_ms=10, fast_path=10, nodes_down=0)


def test_run_ms_node_sharded_equals_jax_run_ms():
    jnet, jstate = jmake(JParams(**P))
    want = jax_numpy(jnet.run_ms(jstate, 400))
    net, state = tmake(TParams(**P), device="cpu")
    mesh = tm.make_mesh2d(1, 8, ["cpu"] * 8)
    placed = shard_state_by_node(net, state, mesh)
    assert not placed.stacked and placed.cells[0][0].done_at.shape == (1, 8)
    out = run_ms_node_sharded(net, placed, 400)
    got = state_to_numpy(out)
    assert got["done_at"].shape == (64,)
    assert_same_state(want, got, "node-sharded Handel 64 x 1, 400 ms")
    per_dev = node_shard_bytes(out, 64)
    for i in range(len(net.protocol.buckets)):
        (key,) = [k for k in per_dev if f"in_sig{i}" in k]
        assert per_dev[key] * 8 == got["proto"][f"in_sig{i}"].nbytes, key
    assert per_dev[".proto['in_key']"] * 8 == got["proto"]["in_key"].nbytes
    assert per_dev[".done_at"] * 8 == np.asarray(got["done_at"]).nbytes
