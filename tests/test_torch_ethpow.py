"""Batched ETHPoW in the port against the JAX package.

Every leaf (name, dtype, shape, bits) of the port's state equals the JAX
package's after 600 000 ms of 10 miners x 3 replicas, for the honest
miners and for each strategy at pos 1 (the two selfish miners and the RL
agent at the JAX tests' 45% share) — runs in which forks occur and the
selfish miners release and lose races; a table of 8 blocks overflows.
The selfish miners' publish0 branch, which needs the public head two
blocks above the private tip, and the agent's `agent_apply_action`
(k = 0, a full release, and one past the withheld count) run on
hand-built states.  The port's event loop equals its per-beat loop, and
both equal the JAX package's, at horizons off the 10 ms grid and in
chained calls.  The mining thresholds equal the JAX package's bit for
bit, and the port's `exp` equals `jnp.exp` over whole binades of its
covered range; the CITIES node builder's columns equal the JAX
builder's.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_paxos import assert_same_state
from wittgenstein_tpu.core.node import Node as JNode
from wittgenstein_tpu.core.node import build_node_columns as jcolumns
from wittgenstein_tpu.core.registries import registry_node_builders as jbuilders
from wittgenstein_tpu.protocols import ethpow_batched as jeth
from wittgenstein_tpu.protocols.ethpow import ETHPoWParameters as JParams
from wittgenstein_tpu.utils.javarand import JavaRandom as JRandom
from wittgenstein_tpu_torch.core.node import Node as TNode
from wittgenstein_tpu_torch.core.node import build_node_columns as tcolumns
from wittgenstein_tpu_torch.core.registries import CITIES, builder_name
from wittgenstein_tpu_torch.core.registries import registry_node_builders as tbuilders
from wittgenstein_tpu_torch.interop import state_from_numpy, state_to_numpy
from wittgenstein_tpu_torch.protocols import ethpow_batched as teth
from wittgenstein_tpu_torch.protocols.ethpow import ETHPoWParameters as TParams

MINERS = 10
REPLICAS = 3
# seeds 16 and 21 fork at the honest miners' rates (two blocks at one
# height within 600 s); every strategy runs on the same three
SEEDS = (0, 16, 21)
SIM_MS = 600_000
VARIANTS = {
    "honest": dict(),
    "selfish": dict(byz_class_name="ETHSelfishMiner", byz_mining_ratio=0.45),
    "selfish2": dict(byz_class_name="ETHSelfishMiner2", byz_mining_ratio=0.45),
    "agent": dict(byz_class_name="ETHMinerAgent", byz_mining_ratio=0.45),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def jax_numpy(state) -> dict:
    return {f.name: np.asarray(getattr(state, f.name)) for f in dataclasses.fields(state)}


@functools.lru_cache(maxsize=None)
def _jnet(variant: str, b_max: int = 512):
    return jeth.BatchedEthPow(JParams(number_of_miners=MINERS, **VARIANTS[variant]), b_max=b_max)


def _tnet(variant: str, b_max: int = 512, **kw):
    return teth.BatchedEthPow(TParams(number_of_miners=MINERS, **VARIANTS[variant]),
                              b_max=b_max, device="cpu", **kw)


@functools.lru_cache(maxsize=None)
def _jax_run(variant: str, ms: int, b_max: int = 512, replicas: int = REPLICAS) -> dict:
    net = _jnet(variant, b_max)
    states = jeth.replicate_ethpow(net.init_state(), replicas, seeds=SEEDS[:replicas])
    return jax_numpy(net.run_ms_batched(states, ms))


def _tstart(net, replicas: int = REPLICAS):
    return teth.replicate_ethpow(net.init_state(), replicas, seeds=SEEDS[:replicas])


class _Spy(teth.BatchedEthPow):
    """Counts, over the replicas that take each beat, the selfish
    receive's lost races and releases (per-beat loop only: the event loop
    also computes beats it discards)."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.seen = {"lose": 0, "release": 0}

    def _selfish_receive(self, s, *args):
        omh, withheld, arrival, lose = super()._selfish_receive(s, *args)
        self.seen["lose"] += int(lose.sum())
        self.seen["release"] += int(((s.withheld & ~withheld).any(1) & ~lose).sum())
        return omh, withheld, arrival, lose


@pytest.mark.parametrize("n", [MINERS, 300])
def test_cities_builder_columns(n):
    """builder_name(CITIES, True, 0) from the port's own city tables gives
    the JAX builder's nodes: cities, positions, columns."""
    name = builder_name(CITIES, True, 0)
    jrd, trd = JRandom(0), JRandom(0)
    jnb, tnb = jbuilders.get_by_name(name), tbuilders.get_by_name(name)
    jnodes = [JNode(jrd, jnb) for _ in range(n)]
    tnodes = [TNode(trd, tnb) for _ in range(n)]
    assert [x.city_name for x in tnodes] == [x.city_name for x in jnodes]
    want, got = jcolumns(jnodes), tcolumns(tnodes)
    assert set(want) == set(got)
    for k in want:
        assert want[k].dtype == got[k].dtype and np.array_equal(want[k], got[k]), k
    assert list(tnb.cities_info) == list(jnb.cities_info)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_init_state_and_columns(variant):
    jnet, tnet = _jnet(variant), _tnet(variant)
    assert np.array_equal(np.asarray(jnet.hp_per_10ms), tnet.hp_per_10ms.numpy())
    for k in jnet.cols:
        assert np.array_equal(jnet.cols[k], tnet.cols[k]), k
    want = jax_numpy(jeth.replicate_ethpow(jnet.init_state(), REPLICAS, seeds=SEEDS))
    got = state_to_numpy(_tstart(tnet))
    assert_same_state(want, got, f"{variant}: initial state")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_run_matches_jax(variant):
    tnet = _tnet(variant)
    got = state_to_numpy(tnet.run_ms(_tstart(tnet), SIM_MS))
    assert_same_state(_jax_run(variant, SIM_MS), got, f"{variant} x {SIM_MS} ms")
    assert (got["overflowed"] == 0).all()
    assert (got["time"] == SIM_MS + 1).all()
    # forks: two blocks at one height, in seeds 16 and 21 at least
    forks = [int(n) - len(np.unique(h[:n])) for h, n in zip(got["height"], got["n_blocks"])]
    assert forks[1] > 0 and forks[2] > 0, forks
    # the event loop ran far fewer iterations than the 60000 beats
    assert tnet.jump_stats["iterations"] < 2000
    assert (tnet.jump_stats["beats"].numpy() < 1000).all()


@pytest.mark.parametrize("variant", ["selfish", "selfish2"])
def test_selfish_runs_release_and_lose(variant):
    """The comparison runs' selfish miners release withheld blocks and lose
    races (the per-beat loop, whose every beat is taken), 2 x 40000 ms;
    equal to the JAX package there too."""
    spy = _Spy(TParams(number_of_miners=MINERS, **VARIANTS[variant]), device="cpu")
    got = state_to_numpy(spy.run_ms_beats(_tstart(spy, 2), 40_000))
    assert_same_state(_jax_run(variant, 40_000, replicas=2), got, f"{variant} per-beat")
    assert spy.seen["release"] > 0 and spy.seen["lose"] > 0, spy.seen


@pytest.mark.parametrize("variant", ["honest", "selfish"])
def test_small_table_overflows(variant):
    """b_max = 8: the table fills and every later block is counted in
    `overflowed` (the drop-mode append's trash row)."""
    tnet = _tnet(variant, b_max=8)
    got = state_to_numpy(tnet.run_ms(_tstart(tnet, 2), 300_000))
    assert_same_state(_jax_run(variant, 300_000, b_max=8, replicas=2), got,
                      f"{variant} b_max=8")
    assert (got["overflowed"] > 0).all() and (got["n_blocks"] == 8).all()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_event_loop_equals_per_beat_loop(variant, monkeypatch):
    """Off-grid horizons in chained calls: the event loop, the per-beat
    loop and a tiny look-ahead chunk (3 beats, so most iterations are
    jumps) give the same state."""
    tnet = _tnet(variant)
    s0 = teth.replicate_ethpow(tnet.init_state(), 2)
    a, b, c = s0, s0, s0
    for ms in (17_003, 9_998, 1):
        a = tnet.run_ms(a, ms)
        b = tnet.run_ms_beats(b, ms)
        with monkeypatch.context() as mp:
            mp.setattr(teth, "CHUNK_BEATS", 3)
            c = tnet.run_ms(c, ms)
    want = state_to_numpy(b)
    assert_same_state(want, state_to_numpy(a), f"{variant}: event loop")
    assert_same_state(want, state_to_numpy(c), f"{variant}: 3-beat chunks")
    # beats from 1 below 17004, then below 27009, then one more
    assert (want["time"] == 27_021).all()


@pytest.mark.parametrize("variant", ["honest", "agent"])
def test_off_grid_horizons_match_jax(variant):
    """The JAX package's per-beat while_loop at the same chained off-grid
    horizons."""
    jnet, tnet = _jnet(variant), _tnet(variant)
    js = jeth.replicate_ethpow(jnet.init_state(), 2)
    ts = teth.replicate_ethpow(tnet.init_state(), 2)
    for ms in (23_457, 6_541):
        js = jnet.run_ms_batched(js, ms)
        ts = tnet.run_ms(ts, ms)
    assert_same_state(jax_numpy(js), state_to_numpy(ts), f"{variant} off-grid")


def test_thresholds_equal_jnp():
    """thresh = 1 - exp(-hp / cand_diff) against jnp's, over every
    difficulty the JAX runs produced and 200000 more across their range:
    equal bit for bit, and every argument inside the port's covered range
    EXP_COVERED (torch's own float32 `exp` misses a few percent)."""
    tnet = _tnet("selfish")
    jnet = _jnet("selfish")
    diffs = [_jax_run(v, SIM_MS)["diff"].ravel() for v in VARIANTS]
    diffs += [_jax_run(v, SIM_MS)["cand_diff"].ravel() for v in VARIANTS]
    run = np.unique(np.concatenate(diffs).astype(np.float32))
    lo, hi = float(run.min()), float(run.max())
    dense = np.random.default_rng(0).uniform(lo, hi, 200_000).astype(np.float32)
    hp = np.array(jnet.hp_per_10ms)
    for cds, tag in ((run, "run"), (dense, "dense")):
        cd = np.repeat(cds[:, None], MINERS, 1)
        x = -jnp.asarray(hp) / jnp.asarray(cd)
        assert teth.EXP_COVERED[0] <= float(-x.max()) and float(-x.min()) < teth.EXP_COVERED[1]
        want = np.asarray(1.0 - jnp.exp(x))
        got = tnet.thresholds(torch.from_numpy(cd)).numpy()
        assert np.array_equal(want.view(np.int32), got.view(np.int32)), tag
        f32 = (1.0 - torch.exp(-torch.from_numpy(hp) / torch.from_numpy(cd))).numpy()
        if tag == "dense":
            assert (f32 != want).mean() > 1e-2


@pytest.mark.parametrize("e", [-11, -20])
def test_exp_equals_jnp_over_a_whole_binade(e):
    """Every float32 x with -x in [2^e, 2^(e+1)): the binade of a 45%
    miner's argument at the genesis difficulty, and the covered range's
    lowest binade.  exp_f32 equals jnp.exp on all 2^23 of them (the
    float64 `exp` rounded to float32 does not)."""
    lo = np.float32(2.0**e).view(np.int32)
    x = -np.arange(lo, lo + (1 << 23), dtype=np.int32).view(np.float32)
    assert -x.max() == 2.0**e and -x.min() < 2.0**(e + 1)
    want = np.asarray(jnp.exp(jnp.asarray(x))).view(np.int32)
    got = teth.exp_f32(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and np.array_equal(got.view(np.int32), want)
    rounded = torch.exp(torch.from_numpy(x).double()).float().numpy().view(np.int32)
    assert (rounded != want).sum() > 0


def _jax_state_at(net, mutate):
    """A JAX single-replica state edited by `mutate`, as two replicas on
    both sides."""
    s = mutate(net.init_state())
    js = jeth.replicate_ethpow(s, 2, seeds=[5, 6])
    return js, state_from_numpy(jax_numpy(js), "cpu")


def _private_chain(n_priv=2, t=1000):
    """The agent withholds blocks 1..n_priv on top of genesis, mining on
    the private tip (candidate stamped 500): the JAX package's
    TestAgentSemantics state."""
    def mutate(s):
        sm = jeth.SELFISH_ID
        mids = jnp.arange(MINERS, dtype=jnp.int32)
        for i in range(1, n_priv + 1):
            row = jnp.where(mids == sm, 0, jeth.INT32_MAX).astype(jnp.int32)
            s = dataclasses.replace(
                s, parent=s.parent.at[i].set(i - 1), height=s.height.at[i].set(s.height[0] + i),
                producer=s.producer.at[i].set(sm), td=s.td.at[i].set(s.td[i - 1] + s.diff[0]),
                arrival=s.arrival.at[i].set(row), withheld=s.withheld.at[i].set(True))
        return dataclasses.replace(
            s, time=jnp.int32(t), n_blocks=jnp.int32(n_priv + 1), pmb=jnp.int32(n_priv),
            head=s.head.at[sm].set(n_priv), father=s.father.at[sm].set(n_priv),
            cand_time=s.cand_time.at[sm].set(500), mining=s.mining.at[sm].set(True))
    return mutate


@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_agent_apply_action(k):
    """k = 0 keeps withholding, 1 releases the oldest, 2 = all (no restamp:
    Java's post-decrement leaves howMany at -1), 3 = all + 1 (the one
    restamp); then a beat and a run from there."""
    jnet, tnet = _jnet("agent"), _tnet("agent")
    js, ts = _jax_state_at(jnet, _private_chain())
    jout = jax.vmap(lambda s: jnet.agent_apply_action(s, k))(js)
    tout = tnet.agent_apply_action(ts, k)
    assert_same_state(jax_numpy(jout), state_to_numpy(tout), f"apply k={k}")
    sm = teth.SELFISH_ID
    assert int(tout.withheld[0].sum()) == max(0, 2 - k)
    assert (int(tout.cand_time[0, sm]) == 1000) == (k == 3)
    jrun = jnet.run_ms_batched(jout, 5_000)
    assert_same_state(jax_numpy(jrun), state_to_numpy(tnet.run_ms(tout, 5_000)), f"run k={k}")


def test_agent_actions_per_replica():
    """Different k per replica in one call."""
    jnet, tnet = _jnet("agent"), _tnet("agent")
    js, ts = _jax_state_at(jnet, _private_chain(n_priv=3))
    ks = np.array([1, 4], np.int32)
    jout = jax.vmap(jnet.agent_apply_action)(js, jnp.asarray(ks))
    tout = tnet.agent_apply_action(ts, torch.from_numpy(ks))
    assert_same_state(jax_numpy(jout), state_to_numpy(tout), "per-replica k")


def _publish0(s):
    """Block 1 is another miner's, block 2 the selfish miner's own on top
    of it (depth 2) and everyone's head; block 3 stands for a public head
    two heights above block 2 with a lower total difficulty, which no one
    has received.  The selfish miner's candidate is certain to succeed,
    everyone else's to fail: its new block lands at delta_p == 0."""
    sm = jeth.SELFISH_ID
    d0 = s.diff[0]
    s = dataclasses.replace(
        s, parent=s.parent.at[1].set(0).at[2].set(1).at[3].set(0),
        height=s.height.at[1].set(s.height[0] + 1).at[2].set(s.height[0] + 2)
        .at[3].set(s.height[0] + 4),
        producer=s.producer.at[1].set(0).at[2].set(sm).at[3].set(2),
        td=s.td.at[1].set(d0).at[2].set(2 * d0).at[3].set(d0 / 2),
        arrival=s.arrival.at[1].set(0).at[2].set(0),
        withheld=s.withheld.at[2].set(True))
    return dataclasses.replace(
        s, time=jnp.int32(5001), n_blocks=jnp.int32(4), pmb=jnp.int32(2), omh=jnp.int32(3),
        head=jnp.full(MINERS, 2, jnp.int32), father=jnp.full(MINERS, 2, jnp.int32),
        mining=jnp.ones(MINERS, bool),
        cand_diff=jnp.full(MINERS, 1e38, jnp.float32).at[sm].set(1.0))


@pytest.mark.parametrize("variant", ["selfish", "selfish2"])
def test_selfish_publish0(variant):
    jnet, tnet = _jnet(variant), _tnet(variant)
    js, ts = _jax_state_at(jnet, _publish0)
    jout = jax.vmap(jnet._beat)(js)
    tout = tnet._beat(ts)
    assert_same_state(jax_numpy(jout), state_to_numpy(tout), f"{variant} publish0 beat")
    # the new block (slot 4) became other_miners_head, and withheld emptied
    assert (tout.omh == 4).all() and not bool(tout.withheld.any())
    jrun = jnet.run_ms_batched(jout, 20_000)
    assert_same_state(jax_numpy(jrun), state_to_numpy(tnet.run_ms(tout, 20_000)),
                      f"{variant} after publish0")


@pytest.mark.parametrize("variant", ["honest", "selfish"])
def test_host_helpers(variant):
    got = state_from_numpy(_jax_run(variant, SIM_MS), "cpu")
    jstate = jeth.EthPowState(**{k: jnp.asarray(v) for k, v in _jax_run(variant, SIM_MS).items()})
    for r in range(REPLICAS):
        assert np.array_equal(teth.chain_producers(got, r), jeth.chain_producers(jstate, r))
        assert teth.selfish_revenue_ratio(got, r) == jeth.selfish_revenue_ratio(jstate, r)
        assert np.array_equal(teth.chain_intervals(got, r), jeth.chain_intervals(jstate, r))


def test_unknown_strategy_and_device(monkeypatch):
    with pytest.raises(NotImplementedError):
        teth.BatchedEthPow(TParams(number_of_miners=3, byz_class_name="ETHAgentMiner"),
                           device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teth.BatchedEthPow(TParams(number_of_miners=3))
