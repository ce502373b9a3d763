"""The port's run cache (parallel/replica_shard.py) against the JAX
package's.

The same call sequence gives the JAX package's run_cache_info counts
(hits, misses, programs under the name `compiles`, size, evictions),
and sharded_run_stats gives the JAX package's five statistics on the
same states.  The design differences are pinned: a program is the first
call at a new input geometry, compile_seconds_total stays 0.0, there is
no compile store, a program's summary holds `replicas` and the cost
and memory of its first call (no memory statistics on the CPU), and a
layout places the states (its geometry the key's third slot) as
shard_replicas does.  The engine's
stable_cache_key holds the JAX package's slots over the port's own
fields, and the double-checked lock keeps a program a singleton under
the interleaving that duplicates it without the recheck.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wittgenstein_tpu.engine import replicate_state as jrep
from wittgenstein_tpu.faults import FaultConfig as JFaultConfig
from wittgenstein_tpu.parallel import replica_shard as jrc
from wittgenstein_tpu.protocols.pingpong_batched import make_pingpong as jmake
from wittgenstein_tpu.telemetry import TelemetryConfig as JTele
from wittgenstein_tpu_torch.engine import replicate_state as trep
from wittgenstein_tpu_torch.faults import FaultConfig as TFaultConfig
from wittgenstein_tpu_torch.parallel import replica_shard as trc
from wittgenstein_tpu_torch.parallel.mesh2d import PlacedState, make_mesh2d_layout
from wittgenstein_tpu_torch.protocols.pingpong_batched import make_pingpong as tmake
from wittgenstein_tpu_torch.runtime import locks as tlocks
from wittgenstein_tpu_torch.telemetry import TelemetryConfig as TTele

KEYS = ("hits", "misses", "evictions", "compiles")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _sequence(rc, make, rep):
    """clear; two engines of one config; two horizons; three widths."""
    rc.clear_run_cache()
    before = rc.run_cache_info()
    net_a, s_a = make(24)
    net_b, _ = make(24)
    fn1 = rc._run_and_reduce(net_a, 40)
    assert rc._run_and_reduce(net_a, 40) is fn1  # same key -> same entry
    assert rc._run_and_reduce(net_b, 40) is not fn1  # another engine
    assert rc._run_and_reduce(net_a, 60) is not fn1  # another horizon
    sizes = [rc.run_cache_info()["size"]]
    for r in (2, 2, 3):
        fn1(rep(s_a, r))
    after = rc.run_cache_info()
    sizes.append(after["size"])
    rc.clear_run_cache()
    sizes.append(rc.run_cache_info()["size"])
    return {k: after[k] - before[k] for k in KEYS}, sizes


def test_call_sequence_counts_equal_jax():
    jd = _sequence(jrc, lambda n: jmake(n, seed=1), jrep)
    td = _sequence(trc, lambda n: tmake(n, seed=1, device="cpu"), trep)
    assert td == jd
    assert td[0] == {"hits": 1, "misses": 3, "evictions": 0, "compiles": 2}
    assert td[1] == [3, 3, 0]


@pytest.mark.parametrize("ms", [150, 600])
def test_stats_equal_jax(ms):
    """The five statistics over the live nodes (two of each replica's 30
    down), at two horizons, byte for byte with their dtypes."""
    down = np.zeros((3, 30), bool)
    down[:, [4, 17]] = True
    jnet, js = jmake(30, seed=2)
    tnet, ts = tmake(30, seed=2, device="cpu")
    jstates = jrep(js, 3)._replace(down=jnp.asarray(down))
    tstates = trep(ts, 3)._replace(down=torch.as_tensor(down))
    _, jstats = jrc.sharded_run_stats(jnet, jstates, ms)
    _, tstats = trc.sharded_run_stats(tnet, tstates, ms)
    assert set(tstats) == set(jstats)
    for k, v in jstats.items():
        want = np.asarray(v)
        got = tstats[k].numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, k
        assert got.tobytes() == want.tobytes(), (k, got, want)


def test_eviction_order_equals_jax(monkeypatch):
    def run(rc, make):
        monkeypatch.setattr(rc, "_RUN_CACHE_MAX", 2)
        rc.clear_run_cache()
        before = rc.run_cache_info()
        net, _ = make(8)
        first = rc._run_and_reduce(net, 10)
        rc._run_and_reduce(net, 20)
        rc._run_and_reduce(net, 10)  # a hit moves 10 ms to the back
        rc._run_and_reduce(net, 30)  # evicts 20 ms
        kept = [key[1] for key in rc._RUN_CACHE]
        again = rc._run_and_reduce(net, 10) is first
        after = rc.run_cache_info()
        rc.clear_run_cache()
        return kept, again, {k: after[k] - before[k] for k in KEYS}

    assert run(trc, lambda n: tmake(n, device="cpu")) == run(jrc, jmake)


def test_design_differences():
    trc.clear_run_cache()
    net, s = tmake(16, device="cpu")
    before = trc.run_cache_info()
    trc.sharded_run_stats(net, trep(s, 2), 20)
    info = trc.run_cache_info()
    assert info["compile_seconds_total"] == 0.0 == before["compile_seconds_total"]
    assert info["store_hits"] == info["store_puts"] == 0
    assert set(info) == set(jrc.run_cache_info())
    metrics = trc.run_cache_metrics()
    (entry,) = metrics["entries"]
    assert {k: entry[k] for k in ("protocol", "sim_ms")} == {
        "protocol": "BatchedPingPong", "sim_ms": 20}
    (prog,) = entry["programs"]
    assert set(prog) == {"replicas", "cost", "memory"} and prog["replicas"] == 2
    assert set(prog["cost"]) == {"wall_seconds", "hand_launches"}
    assert prog["cost"]["wall_seconds"] > 0 and prog["cost"]["hand_launches"] == 0
    assert prog["memory"] is None  # no allocator statistics on the CPU
    # a layout places the states and keys the entry on its geometry
    lay = make_mesh2d_layout(2, 1, ["cpu", "cpu"])
    out, stats = trc.sharded_run_stats(net, trep(s, 2), 20, layout=lay)
    assert isinstance(out, PlacedState) and out.layout is lay
    ref, ref_stats = trc.sharded_run_stats(net, trep(s, 2), 20)
    assert all(torch.equal(v, stats[k]) for k, v in ref_stats.items())
    assert {key[2] for key in trc._RUN_CACHE} == {None, lay.geometry()}
    rows = trc.shard_replicas(trep(s, 2), lay.mesh)
    assert isinstance(rows, PlacedState) and rows.cells[1][0].time.shape == (1,)
    trc.clear_run_cache()


def test_stable_cache_key_holds_jax_slots():
    """Name, params, latency, store geometry, discard time, throughput,
    telemetry, faults, batched_jumps and lanes: the JAX package's slots;
    the device stands where the JAX package has its bitset backend."""
    jnet, js = jmake(40, telemetry=JTele(snapshots=8, snapshot_every_ms=5))
    tnet, ts = tmake(40, telemetry=TTele(snapshots=8, snapshot_every_ms=5), device="cpu")
    jnet, _ = jnet.with_faults(js, JFaultConfig())
    tnet, _ = tnet.with_faults(ts, TFaultConfig())
    jkey, tkey = jnet.stable_cache_key(), tnet.stable_cache_key()
    assert tkey[:10] == jkey[:10]
    assert tkey[10:14] == (jkey[11], jkey[12], jkey[15], jkey[16])
    assert tkey[14] == "cpu"
    full = tnet.cache_key()
    assert full[2:4] == (id(tnet.protocol), id(tnet.latency))
    assert full[:2] + full[4:] == tkey


@pytest.mark.parametrize("recheck", [True, False])
def test_concurrent_miss_registers_one_program(monkeypatch, recheck):
    """Two threads miss one geometry at once (both held at the
    lookup-miss yield point): with the recheck under the lock one
    program is registered, without it two."""
    monkeypatch.setattr(trc, "_RECHECK_UNDER_LOCK", recheck)
    trc.clear_run_cache()
    net, s = tmake(8, device="cpu")
    fn = trc._run_and_reduce(net, 5)
    gate = threading.Barrier(2, timeout=30)

    def controller(name):
        if name == "runcache.lookup-miss":
            gate.wait()

    before = trc.run_cache_info()["compiles"]
    tlocks.set_interleave(controller)
    try:
        threads = [threading.Thread(target=fn, args=(trep(s, 2),)) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        tlocks.set_interleave(None)
    assert trc.run_cache_info()["compiles"] - before == (1 if recheck else 2)
    trc.clear_run_cache()
