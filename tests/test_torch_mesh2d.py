"""The port's 2D mesh (parallel/mesh2d.py, parallel/exchange.py) against
the JAX package's mesh2d, on CPU devices that repeat.

`classify_leaf` gives the JAX package's class for every leaf of the
handel, pingpong and p2pflood registry states, single and stacked, over
the same keystr paths; `make_mesh2d` and `MeshLayout` raise the JAX
package's errors word for word and give its `geometry()`, `describe()`
and partition specs; placement cuts every leaf by that rule, a node
column's shard owns exactly its 1/P of the bytes, and `gather` gives the
state back bit for bit; the exchange's three operations equal their
concatenated math; and no module of the sharded path moves a tensor
between devices outside the exchange.
"""

import ast
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from wittgenstein_tpu.core.registries import registry_batched_protocols as jreg
from wittgenstein_tpu.parallel import mesh2d as jm
from wittgenstein_tpu.parallel.node_shard import _MESSAGE_STORE_FIELDS as J_FIELDS
from wittgenstein_tpu_torch.core.registries import registry_batched_protocols as treg
from wittgenstein_tpu_torch.engine import replicate_state
from wittgenstein_tpu_torch.parallel import exchange
from wittgenstein_tpu_torch.parallel import mesh2d as tm
from wittgenstein_tpu_torch.parallel.node_shard import _MESSAGE_STORE_FIELDS as T_FIELDS

CPU8 = ["cpu"] * 8
R = 8
ROOT = Path(__file__).resolve().parent.parent


def _message(fn, exc=ValueError):
    try:
        fn()
    except exc as e:
        return str(e)
    return None


def test_store_fields_are_the_jax_packages():
    assert T_FIELDS == J_FIELDS


@pytest.mark.parametrize("name", ["handel", "pingpong", "p2pflood"])
def test_classify_every_registry_leaf_as_jax(name):
    """Same keystr paths, same classes, single and stacked."""
    jnet, jstate = jreg.get(name).factory()
    tnet, tstate = treg.get(name).factory(device="cpu")
    jleaves = [(jax.tree_util.keystr(kp), tuple(leaf.shape))
               for kp, leaf in jax.tree_util.tree_flatten_with_path(jstate)[0]]
    tleaves = [(k, tuple(a.shape)) for k, a in tm.keyed_leaves(tstate)]
    assert sorted(tleaves) == sorted(jleaves)
    n = tnet.n_nodes
    for key, shape in tleaves:
        for stacked, full in ((False, shape), (True, (R,) + shape)):
            assert tm.classify_leaf(key, full, n, stacked) == jm.classify_leaf(
                key, full, n, stacked), (key, stacked)


def test_classify_rules_as_jax():
    cases = [(f"{f}[0]", (R, 64, 3), 64, True) for f in (".msg_arrival", ".tele", ".faults",
                                                         ".whl_fill")]
    cases += [(".proto['x']", (R, 64), 64, True), (".proto['x']", (64,), 64, False),
              (".time", (R,), 64, True), (".time", (), 64, False)]
    for case in cases:
        assert tm.classify_leaf(*case) == jm.classify_leaf(*case), case


@pytest.mark.parametrize("p_r,p_n,n_dev", [(2, 8, 8), (0, 8, 8), (8, 0, 8), (3, 3, 8), (2, 2, 3)])
def test_make_mesh2d_errors_as_jax(p_r, p_n, n_dev):
    want = _message(lambda: jm.make_mesh2d(p_r, p_n, jax.devices()[:n_dev]))
    got = _message(lambda: tm.make_mesh2d(p_r, p_n, ["cpu"] * n_dev))
    assert want is not None and got == want


def test_layout_errors_geometry_and_specs_as_jax():
    jmesh, tmesh = jm.make_mesh2d(2, 4), tm.make_mesh2d(2, 4, CPU8)
    for kw in ({"replica_axis": None, "node_axis": None}, {"replica_axis": "bogus"},
               {"node_axis": "bogus"}):
        want = _message(lambda: jm.MeshLayout(jmesh, **kw))
        assert want is not None and _message(lambda: tm.MeshLayout(tmesh, **kw)) == want
    for p_r, p_n in ((2, 4), (4, 2), (8, 1), (1, 8)):
        ja = jm.make_mesh2d_layout(p_r, p_n)
        ta = tm.make_mesh2d_layout(p_r, p_n, CPU8)
        assert ta.geometry() == ja.geometry()
        assert ta.describe() == ja.describe()
        assert (ta.p_replica, ta.p_node, ta.n_devices) == (ja.p_replica, ja.p_node, ja.n_devices)
        assert tm.make_mesh2d_layout(p_r, p_n, CPU8).geometry() == ta.geometry()
    assert tm.make_mesh2d_layout(2, 4, CPU8).geometry() != tm.make_mesh2d_layout(
        4, 2, CPU8).geometry()
    for axes in (("replicas", "nodes"), ("replicas", None), (None, "nodes")):
        jl, tl = jm.MeshLayout(jmesh, *axes), tm.MeshLayout(tmesh, *axes)
        for key, shape in ((".proto['agg']", (R, 64, 2)), (".time", (R,)),
                           (".msg_valid", (R, 64, 64)), (".x", (64,))):
            assert tl.spec_for(key, shape, 64) == tuple(jl.spec_for(key, shape, 64)), \
                (axes, key)


def test_validate_errors_as_jax():
    jnet, jstate = jreg.get("handel").factory()
    tnet, tstate = treg.get("handel").factory(device="cpu")
    jl, tl = jm.make_mesh2d_layout(2, 4), tm.make_mesh2d_layout(2, 4, CPU8)
    from wittgenstein_tpu.engine import replicate_state as jrep

    want = _message(lambda: jl.validate(jnet, jrep(jstate, R - 1)))
    got = _message(lambda: tl.validate(tnet, replicate_state(tstate, R - 1)))
    assert want is not None and got == want

    class _Six:
        n_nodes = 6

    want = _message(lambda: jl.validate(_Six(), jrep(jstate, R)))
    assert want is not None and _message(lambda: tl.validate(_Six(), replicate_state(
        tstate, R))) == want


@pytest.mark.parametrize("p_r,p_n", [(2, 4), (4, 2), (1, 8)])
def test_place_owns_its_share_and_gathers_back(p_r, p_n):
    net, state = treg.get("handel").factory(device="cpu")
    states = replicate_state(state, R)
    placed = tm.make_mesh2d_layout(p_r, p_n, CPU8).place(net, states)
    n = net.n_nodes
    for key, shape, nbytes, shards in placed.leaf_shards():
        node_col = key in placed.node_keys
        assert node_col == (tm.classify_leaf(key, shape, n) == "node-column"), key
        for s in shards:
            # every cell's leaf is a storage of its own, exactly its bytes
            assert s.untyped_storage().nbytes() == s.numel() * s.element_size(), key
            assert s.shape[0] == R // p_r
            if node_col:
                assert s.shape[1] == n // p_n
                assert s.numel() * s.element_size() * p_r * p_n == nbytes, key
    owned = tm.assert_channel_ownership(net, placed)
    assert owned and all(per * 8 == total for per, total in owned.values())
    back = placed.gather()
    for (ka, a), (kb, b) in zip(tm.keyed_leaves(states), tm.keyed_leaves(back)):
        assert ka == kb and a.dtype == b.dtype and torch.equal(a, b), ka
        assert a.numel() == 0 or a.data_ptr() != b.data_ptr(), ka
    with pytest.raises(AssertionError, match="ownership"):
        tm.assert_channel_ownership(net, states, n_devices=8)
    pnet, pstate = treg.get("pingpong").factory(device="cpu")
    pplaced = tm.make_mesh2d_layout(p_r, p_n, CPU8).place(pnet, replicate_state(pstate, R))
    assert tm.channel_ownership(pnet, pplaced) == {}
    with pytest.raises(AssertionError, match="no in_sig"):
        tm.assert_channel_ownership(pnet, pplaced)


@pytest.mark.parametrize("p", [1, 3, 4])
def test_exchange_equals_concatenated_math(p):
    gen = torch.Generator().manual_seed(p)
    group = exchange.Group(["cpu"] * p)
    mine = [torch.randint(-50, 50, (p, 3, 2), generator=gen, dtype=torch.int32)
            for _ in range(p)]
    flags = [torch.rand(5, generator=gen) > 0.5 for _ in range(p)]

    def task(rank):
        a2a = exchange.all_to_all(group, rank, [mine[rank], mine[rank] * 2])
        gat = exchange.all_gather(group, rank, [mine[rank]], dim=1)[0]
        red = {op: exchange.all_reduce(group, rank, mine[rank], op)
               for op in ("sum", "min", "max")}
        red.update({op: exchange.all_reduce(group, rank, flags[rank], op)
                    for op in ("all", "any")})
        return a2a, gat, red

    outs = exchange.spmd([lambda r=r: task(r) for r in range(p)], [group])
    stack = torch.stack(mine)
    for rank, (a2a, gat, red) in enumerate(outs):
        assert torch.equal(a2a[0], stack[:, rank]) and torch.equal(a2a[1], 2 * stack[:, rank])
        assert torch.equal(gat, torch.cat(mine, 1))
        assert torch.equal(red["sum"], stack.sum(0, dtype=torch.int32))
        assert torch.equal(red["min"], stack.amin(0)) and torch.equal(red["max"], stack.amax(0))
        assert torch.equal(red["all"], torch.stack(flags).all(0))
        assert torch.equal(red["any"], torch.stack(flags).any(0))
        # a result never aliases a member's tensor
        assert all(a2a[0].data_ptr() != m.data_ptr() for m in mine)
    with pytest.raises(ValueError, match="all_reduce op"):
        exchange.all_reduce(exchange.Group(["cpu"]), 0, mine[0], "mean")


def test_a_failing_cell_releases_the_others():
    group = exchange.Group(["cpu"] * 3)

    def task(rank):
        if rank == 1:
            raise RuntimeError("cell 1 failed")
        return exchange.all_reduce(group, rank, torch.ones(2), "max")

    with pytest.raises(RuntimeError, match="cell 1 failed"):
        exchange.spmd([lambda r=r: task(r) for r in range(3)], [group])


# the modules of the sharded path, and the engine and protocol code the
# node axis runs: a device move (`.to(device)`, `.cuda()`, `.cpu()`)
# happens only in parallel/exchange.py
SHARDED_PATH = [
    "parallel/mesh2d.py", "parallel/node_shard.py", "parallel/replica_shard.py",
    "parallel/device_groups.py", "engine/core.py", "protocols/_agg_batched.py",
    "protocols/handel_batched.py", "protocols/pingpong_batched.py",
    "protocols/p2pflood_batched.py",
]
_DTYPE_NAMES = {"int8", "int16", "int32", "int64", "uint8", "bool", "float32", "float64",
                "float16", "bfloat16", "long", "int", "float"}


def _device_moves(path: Path) -> list:
    """Calls that may move a tensor between devices: `.cuda()`, `.cpu()`,
    and `.to(...)` with any argument that is not a dtype."""
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
            continue
        name = node.func.attr
        if name in ("cuda", "cpu"):
            bad.append(node.lineno)
        elif name == "to":
            args = list(node.args) + [k.value for k in node.keywords if k.arg != "dtype"]
            for a in args:
                dtype = (isinstance(a, ast.Attribute) and (a.attr in _DTYPE_NAMES
                                                           or a.attr == "dtype")) \
                    or (isinstance(a, ast.Name) and a.id.endswith("dtype"))
                if not dtype:
                    bad.append(node.lineno)
    return bad


@pytest.mark.parametrize("rel", SHARDED_PATH)
def test_devices_are_crossed_only_in_the_exchange(rel):
    path = ROOT / "wittgenstein_tpu_torch" / rel
    assert _device_moves(path) == [], rel
    assert _device_moves(ROOT / "wittgenstein_tpu_torch" / "parallel" / "exchange.py")


def test_exchange_under_thread_stress():
    """More members than cores, a short switch interval, many rounds:
    every all_reduce sum is exact, so no member's contribution is lost
    or read from another round."""
    import os
    import sys
    import threading

    p, rounds = max(12, 2 * (os.cpu_count() or 4)), 60
    group = exchange.Group(["cpu"] * p)

    def task(rank):
        sums = []
        for i in range(rounds):
            x = torch.tensor([rank + 1000 * i], dtype=torch.int64)
            sums.append(int(exchange.all_reduce(group, rank, x, "sum")))
        return sums

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    box = {}
    try:
        runner = threading.Thread(
            target=lambda: box.update(out=exchange.spmd([lambda r=r: task(r) for r in range(p)],
                                                        [group])), daemon=True)
        runner.start()
        runner.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not runner.is_alive()
    want = [p * (p - 1) // 2 + p * 1000 * i for i in range(rounds)]
    assert box["out"] == [want] * p
