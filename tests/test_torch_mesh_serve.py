"""The layout-aware paths around the port's mesh, on CPU devices that
repeat, against the JAX package's:

- device groups: the JAX package's test_device_groups.py cases on eight
  CPU devices — contiguous equal groups, replica-split placement when
  the rows divide, node columns split too with `net` on a 2D group,
  the first device otherwise, bytes unchanged;
- the run cache: (2, 4) and (4, 2) layouts are two entries beside the
  unsharded one, their leaves and five statistics the unsharded run's,
  a fresh layout of one geometry hits, `shard_replicas` splits rows;
- two scheduler lanes on [cpu] x 2, each with families of its own:
  every job's digest the JAX package's `run_singleton`'s;
- checkpoints across layouts (the JAX package's TestMeshPortability): a
  save from an unsharded run resumes on a (2, 4) template and a save
  from a (2, 4) run resumes unsharded, bitwise equal to the straight
  run, a (2, 4) save restores on (4, 2), and the run key ignores
  placement.
"""

import pytest
import torch

from test_serve import SCENARIOS
from wittgenstein_tpu.serve import BatchScheduler as JScheduler
from wittgenstein_tpu_torch.core.registries import registry_batched_protocols as treg
from wittgenstein_tpu_torch.engine import replicate_state
from wittgenstein_tpu_torch.engine.checkpoint import load_state, save_state
from wittgenstein_tpu_torch.parallel import device_groups as tdg
from wittgenstein_tpu_torch.parallel import mesh2d as tm
from wittgenstein_tpu_torch.parallel import replica_shard as trc
from wittgenstein_tpu_torch.protocols.handel import HandelParameters
from wittgenstein_tpu_torch.protocols.handel_batched import make_handel
from wittgenstein_tpu_torch.runtime import stable_run_key
from wittgenstein_tpu_torch.serve import BatchScheduler, JobState
from wittgenstein_tpu_torch.serve import scheduler as tsched

CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _same(a, b, tag=""):
    for (ka, x), (kb, y) in zip(tm.keyed_leaves(a), tm.keyed_leaves(b)):
        assert ka == kb and x.dtype == y.dtype and torch.equal(x, y), (tag, ka)


def _pingpong(rows=4):
    net, state = treg.get("pingpong").factory(device="cpu")
    return net, replicate_state(state, rows)


# -- device groups: the JAX package's cases on eight CPU devices ----------

def test_groups_are_contiguous_disjoint_equal():
    groups = tdg.make_device_groups(2, devices=CPU8)
    assert [g.index for g in groups] == [0, 1]
    assert all(len(g.devices) == 4 for g in groups)
    assert [d for g in groups for d in g.devices] == [torch.device("cpu")] * 8
    (whole,) = tdg.make_device_groups(1, devices=CPU8)
    assert len(whole.devices) == 8 and whole.label() == "group0[8dev]"
    for bad in (0, 9, 3):
        with pytest.raises(ValueError):
            tdg.make_device_groups(bad, devices=CPU8)


def test_group_placement_rules():
    net, states = _pingpong(rows=4)
    g = tdg.make_device_groups(2, devices=CPU8)[1]
    placed = g.place(states)
    assert isinstance(placed, tm.PlacedState)
    assert placed.layout.p_replica == 4 and placed.layout.node_axis is None
    _same(placed.gather(), states, "replica split")
    whole = g.place(replicate_state(treg.get("pingpong").factory(device="cpu")[1], 5))
    assert not isinstance(whole, tm.PlacedState) and whole.time.shape == (5,)
    assert g.mesh.devices.shape == (4,) and g.label() == "group1[4dev]"
    assert g.layout().node_axis is None and g.layout().p_node == 1
    assert g.sharding().geometry() == g.layout().geometry()


def test_2d_group_placement():
    net, states = _pingpong(rows=4)
    g = tdg.make_device_groups(2, devices=CPU8, node_parallel=2)[1]
    assert (g.replica_parallel, g.node_parallel) == (2, 2)
    assert g.mesh.devices.shape == (2, 2) and g.mesh.axis_names == ("replicas", "nodes")
    assert (g.layout().p_replica, g.layout().p_node) == (2, 2) and g.label() == "group1[2x2]"
    placed = g.place(states, net=net)
    specs = {placed.layout.spec_for(k, s, net.n_nodes) for k, s, _, _ in placed.leaf_shards()}
    assert specs == {("replicas", "nodes"), ("replicas",)}
    _same(placed.gather(), states, "2d")
    no_net = g.place(states)
    assert no_net.layout.node_axis is None and not no_net.node_keys

    class _OddNet:
        n_nodes = 7

    odd = g.place(states, net=_OddNet())
    assert odd.layout.node_axis is None
    with pytest.raises(ValueError):
        tdg.make_device_groups(2, devices=CPU8, node_parallel=3)
    with pytest.raises(ValueError):
        tdg.DeviceGroup(0, tuple(CPU8[:4]), node_parallel=3)


# -- the run cache's layouts ------------------------------------------------

def test_layouts_are_distinct_cache_entries_with_equal_stats():
    net, states = _pingpong(rows=8)
    trc.clear_run_cache()
    ref, ref_stats = trc.sharded_run_stats(net, states, 40)
    a = tm.make_mesh2d_layout(2, 4, CPU8)
    b = tm.make_mesh2d_layout(4, 2, CPU8)
    out_a, stats_a = trc.sharded_run_stats(net, states, 40, layout=a)
    out_b, stats_b = trc.sharded_run_stats(net, states, 40, layout=b)
    assert {k[2] for k in trc._RUN_CACHE} == {None, a.geometry(), b.geometry()}
    for out, stats in ((out_a, stats_a), (out_b, stats_b)):
        assert isinstance(out, tm.PlacedState)
        _same(out.gather(), ref)
        for k, v in ref_stats.items():
            assert v.dtype == stats[k].dtype and torch.equal(v, stats[k]), k
    hits = trc.run_cache_info()["hits"]
    trc.sharded_run_stats(net, states, 40, layout=tm.make_mesh2d_layout(2, 4, CPU8))
    assert trc.run_cache_info()["hits"] == hits + 1
    rows = trc.shard_replicas(states, tm.make_mesh2d(8, 1, CPU8), axis="replicas")
    assert rows.layout.p_replica == 8 and rows.cells[3][0].time.shape == (1,)
    out_r, stats_r = trc.sharded_run_stats(net, rows, 40)
    _same(out_r.gather(), ref)
    assert all(torch.equal(v, stats_r[k]) for k, v in ref_stats.items())
    trc.clear_run_cache()


# -- scheduler lanes ----------------------------------------------------------

def test_two_lanes_on_cpu_devices_give_jax_digests(monkeypatch):
    monkeypatch.setattr(tsched, "visible_devices", lambda kind="cuda": ["cpu", "cpu"])
    sched = BatchScheduler(device="cpu", auto_start=False, max_batch_replicas=4,
                           device_groups=2)
    assert [lane.group.devices for lane in sched._lanes] == [(torch.device("cpu"),)] * 2
    # two families (32 and 16 nodes), so each lane takes one
    specs = SCENARIOS[:4] + [{**s, "params": {"node_ct": 16}} for s in SCENARIOS[4:]]
    jobs = [sched.submit(s) for s in specs]
    while sched.drain_once(0) | sched.drain_once(1):
        pass
    jax_sched = JScheduler(auto_start=False)
    for j, s in zip(jobs, specs):
        assert j.state is JobState.DONE, (s, j.error)
        assert j.result["digest"] == jax_sched.run_singleton(s)["digest"], s
    assert all(lane.dispatches > 0 for lane in sched._lanes)
    # each lane built families of its own
    assert sorted(k.rsplit("@", 1)[1] for k in sched._families) == ["lane0", "lane1"]


# -- checkpoints across layouts --------------------------------------------

def _handel(replicas=4):
    p = HandelParameters(node_count=32, threshold=28, pairing_time=3, level_wait_time=20,
                         extra_cycle=5, dissemination_period_ms=10, fast_path=5, nodes_down=0)
    net, state = make_handel(p, device="cpu")
    return net, replicate_state(state, replicas)


def test_checkpoints_cross_layouts(tmp_path):
    net, states = _handel()
    mid = net.run_ms_batched(states, 60)
    straight = net.run_ms_batched(mid, 60)
    lay = tm.make_mesh2d_layout(2, 4, CPU8)

    ckpt = str(tmp_path / "mid1d.npz")
    save_state(mid, ckpt)
    restored = load_state(lay.place(net, mid), ckpt)
    assert isinstance(restored, tm.PlacedState) and restored.layout is lay
    _same(net.run_ms_batched(restored, 60).gather(), straight, "1d -> 2d")

    mid2 = net.run_ms_batched(lay.place(net, states), 60)
    ckpt2 = str(tmp_path / "mid2d.npz")
    save_state(mid2, ckpt2)
    back = load_state(mid, ckpt2)
    assert not isinstance(back, tm.PlacedState)
    _same(net.run_ms_batched(back, 60), straight, "2d -> unsharded")
    t = load_state(tm.make_mesh2d_layout(4, 2, CPU8).place(net, mid2), ckpt2)
    assert (t.layout.p_replica, t.layout.p_node) == (4, 2)
    _same(t.gather(), mid2.gather(), "2d -> transposed")

    assert stable_run_key(net, states, 4, 100) == stable_run_key(net, lay.place(net, states),
                                                                 4, 100)
    net2, states2 = _handel(replicas=8)
    assert stable_run_key(net, states, 4, 100) != stable_run_key(net2, states2, 4, 100)
