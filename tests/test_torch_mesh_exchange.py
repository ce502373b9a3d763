"""The channel exchange's capacity on the port's node axis: the port
commits every node-sharded send through the exchange, at the exact
capacity unless `enable_node_sharding` bounds it — a design difference
from the JAX package, whose engine without that call partitions the
commit with XLA — so a run on a placed state with the plain engine
equals one with `enable_node_sharding` and its displaced count the
unsharded run's, while a bound of 2 rows a bucket counts more
`displaced`.  `enable_node_sharding` copies the engine, and its cache
keys gain the node axis and the mesh, as the JAX package's do.  A
protocol without node-block hooks, and a fault-armed engine, raise on
an active node axis naming the ROADMAP item that ports them, and run
on the replica axis.
"""

import numpy as np
import pytest
import torch

from wittgenstein_tpu_torch.core.registries import registry_batched_protocols as treg
from wittgenstein_tpu_torch.engine import replicate_state
from wittgenstein_tpu_torch.parallel import mesh2d as tm
from wittgenstein_tpu_torch.parallel.node_shard import enable_node_sharding

CPU8 = ["cpu"] * 8


def test_exchange_capacity_exact_by_default_and_bounded_counts():
    net, state = treg.get("handel").factory(device="cpu")
    states = replicate_state(state, 2)
    layout = tm.make_mesh2d_layout(1, 8, CPU8)
    plain = net.run_ms_batched(layout.place(net, states), 60).gather()
    exact_net = enable_node_sharding(net, layout.mesh)
    exact = exact_net.run_ms_batched(layout.place(exact_net, states), 60).gather()
    for (k, a), (_, b) in zip(tm.keyed_leaves(plain), tm.keyed_leaves(exact)):
        assert np.array_equal(a.numpy(), b.numpy()), k
    assert np.array_equal(plain.proto["displaced"].numpy(),
                          net.run_ms_batched(states, 60).proto["displaced"].numpy())
    bounded = enable_node_sharding(net, layout.mesh, exchange_capacity=2)
    out = bounded.run_ms_batched(layout.place(bounded, states), 60).gather()
    assert out.done_at.shape == (2, net.n_nodes)
    assert (out.proto["displaced"] > plain.proto["displaced"]).all()


def test_node_sharding_keys():
    net, _ = treg.get("handel").factory(device="cpu")
    mesh = tm.make_mesh2d(1, 8, CPU8)
    sharded = enable_node_sharding(net, mesh, exchange_capacity=4)
    assert sharded is not net and net.node_mesh is None
    assert sharded.stable_cache_key()[-1] == "nodes" and net.stable_cache_key()[-1] is None
    assert sharded.cache_key()[-1] == id(mesh)
    assert sharded.cache_key() != net.cache_key()
    assert enable_node_sharding(net, tm.make_mesh2d(1, 8, CPU8)).cache_key() \
        != sharded.cache_key()


def test_uncovered_node_axis_raises_naming_its_item():
    """A protocol without node-block hooks, or a fault-armed engine,
    placed with an active node axis raises naming the ROADMAP item that
    ports it; with the replica axis alone both run."""
    states = {}
    for name in ("gsf", "p2pflood_faults"):
        net, state = treg.get(name).factory(device="cpu")
        states[name] = (net, replicate_state(state, 2))
    net, batch = states["gsf"]
    placed = tm.make_mesh2d_layout(1, 2, ["cpu"] * 2).place(net, batch)
    with pytest.raises(NotImplementedError, match="Queue A 1 .the node axis"):
        net.run_ms_batched(placed, 5)
    fnet, fbatch = states["p2pflood_faults"]
    fplaced = tm.make_mesh2d_layout(1, 2, ["cpu"] * 2).place(fnet, fbatch)
    with pytest.raises(NotImplementedError, match="Queue A 2 .fault-armed"):
        fnet.run_ms_batched(fplaced, 5)
    rows = tm.make_mesh2d_layout(2, 1, ["cpu"] * 2)
    for net, batch in states.values():
        out = net.run_ms_batched(rows.place(net, batch), 5).gather()
        want = net.run_ms_batched(batch, 5)
        for (k, a), (_, b) in zip(tm.keyed_leaves(out), tm.keyed_leaves(want)):
            assert torch.equal(a, b), k
