"""Seeded contract defects: the same defect, written against each
package's PingPong, gives the same rule ids in both.

Each defect of the JAX package's own simlint suite (tests/test_simlint.py:
SL401, SL402, SL405, SL406, SL407, SL901 twice, SL1201 three times and
the SIMLINT_SUPPRESS case) and the stale derived cache of its
tests/test_score_cache.py (SL701) is written twice — as a subclass of
the JAX package's BatchedPingPong and of the port's, whose hooks take
the tick `t` — and run through both packages' check_entry / audit_entry
on the CPU.  The port's checks run its hooks concretely; the JAX
package's trace them.  Both must name the same rules.  A Handel whose
commit skips the score-cache update is SL701 in both packages.
"""

import copy

import jax.numpy as jnp
import pytest
import torch

from wittgenstein_tpu.analysis.contracts import _check_derived_cache as jcheck_sl701
from wittgenstein_tpu.analysis.contracts import _cpu_jax
from wittgenstein_tpu.analysis.contracts import check_entry as jcheck
from wittgenstein_tpu.analysis.rng_audit import audit_entry as jaudit
from wittgenstein_tpu.core.registries import BatchedProtocolEntry as JEntry
from wittgenstein_tpu.core.registries import registry_batched_protocols as jreg
from wittgenstein_tpu.engine.density import NarrowLeaf as JNarrow
from wittgenstein_tpu.protocols.handel_batched import BatchedHandel as JHandel
from wittgenstein_tpu.protocols.pingpong_batched import BatchedPingPong as JPP
from wittgenstein_tpu.protocols.pingpong_batched import make_pingpong as jmake
from wittgenstein_tpu_torch.analysis.contracts import check_entry as tcheck
from wittgenstein_tpu_torch.analysis.rng_audit import audit_entry as taudit
from wittgenstein_tpu_torch.core.registries import BatchedProtocolEntry as TEntry
from wittgenstein_tpu_torch.core.registries import registry_batched_protocols as treg
from wittgenstein_tpu_torch.engine import map_state
from wittgenstein_tpu_torch.engine.density import NarrowLeaf as TNarrow
from wittgenstein_tpu_torch.protocols.handel_batched import BatchedHandel as THandel
from wittgenstein_tpu_torch.protocols.pingpong_batched import BatchedPingPong as TPP
from wittgenstein_tpu_torch.protocols.pingpong_batched import make_pingpong as tmake


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _jentry(cls, with_caches=False):
    def factory():
        net, state = jmake(32)
        net = copy.copy(net)
        net.protocol = cls(32)
        if with_caches:
            state = state._replace(proto=dict(state.proto,
                                              **net.protocol.recompute_caches(state)))
        return net, state

    return JEntry("bad", "fixture_batched", factory)


def _tentry(cls, with_caches=False):
    def factory(device=None):
        net, state = tmake(32, device=device)
        net = copy.copy(net)
        net.protocol = cls(32)
        if with_caches:
            state = state._replace(proto=dict(state.proto,
                                              **net.protocol.recompute_caches(state)))
        return net, state

    return TEntry("bad", "fixture_batched", factory)


# -- the defects, each as (JAX class, port class) ----------------------------


class JBadDeliver(JPP):
    def deliver(self, net, state, deliver_mask):
        state, em = super().deliver(net, state, deliver_mask)
        return state._replace(msg_valid=jnp.zeros_like(state.msg_valid)), em


class TBadDeliver(TPP):
    def deliver(self, net, state, deliver_mask, t):
        state, em = super().deliver(net, state, deliver_mask, t)
        return state._replace(msg_valid=torch.zeros_like(state.msg_valid)), em


class JDriftingTick(JPP):
    def tick(self, net, state):
        return state._replace(done_at=state.done_at.astype(jnp.float32))


class TDriftingTick(TPP):
    def tick(self, net, state, t):
        return state._replace(done_at=state.done_at.to(torch.float32))


class JFaultSensitive(JPP):
    # peeks at whether the fault side-car is armed: a neutral schedule
    # then changes non-fault state
    def deliver(self, net, state, deliver_mask):
        import jax

        state, em = super().deliver(net, state, deliver_mask)
        if len(jax.tree_util.tree_leaves(state.faults)) > 0:
            state = state._replace(proto={"pong": state.proto["pong"] + jnp.int32(1)})
        return state, em


class TFaultSensitive(TPP):
    def deliver(self, net, state, deliver_mask, t):
        state, em = super().deliver(net, state, deliver_mask, t)
        if len(state.faults) > 0:
            state = state._replace(proto={"pong": state.proto["pong"] + 1})
        return state, em


class JFaultWriter(JPP):
    def deliver(self, net, state, deliver_mask):
        state, em = super().deliver(net, state, deliver_mask)
        if len(state.faults) > 0:
            fs = state.faults
            state = state._replace(
                faults=fs._replace(dropped_by_fault=fs.dropped_by_fault + jnp.int32(1)))
        return state, em


class TFaultWriter(TPP):
    def deliver(self, net, state, deliver_mask, t):
        state, em = super().deliver(net, state, deliver_mask, t)
        if len(state.faults) > 0:
            fs = state.faults
            state = state._replace(faults=fs._replace(dropped_by_fault=fs.dropped_by_fault + 1))
        return state, em


class JUnnarrowedInit(JPP):
    # declares a narrow plan but proto_init still seeds the leaf at int32
    NARROW_LEAVES = (JNarrow("pong", "int8", 100),)


class TUnnarrowedInit(TPP):
    NARROW_LEAVES = (TNarrow("pong", "int8", 100),)


class JNoSentinelRoom(JPP):
    # int8 max is 127, which the sentinel reserves
    NARROW_LEAVES = (JNarrow("pong", "int8", 127, sentinel=True),)


class TNoSentinelRoom(TPP):
    NARROW_LEAVES = (TNarrow("pong", "int8", 127, sentinel=True),)


class JLyingJumper(JPP):
    # TICK_INTERVAL None (jumpable) but per-tick beat work
    def tick_beat(self, net, state):
        return state._replace(proto={"pong": state.proto["pong"] + jnp.int32(1)})


class TLyingJumper(TPP):
    def tick_beat(self, net, state, t):
        return state._replace(proto={"pong": state.proto["pong"] + 1})


class JPeriodicJumper(JPP):
    BEAT_PERIOD = 10
    BEAT_RESIDUES = (0,)
    BEAT_SEND_CALLS = 0


class TPeriodicJumper(TPP):
    BEAT_PERIOD = 10
    BEAT_RESIDUES = (0,)
    BEAT_SEND_CALLS = 0


class JHonestBeater(JPP):
    # the same mutating beat is fine once ticks are not declared skippable
    TICK_INTERVAL = 1

    def tick_beat(self, net, state):
        return state._replace(proto={"pong": state.proto["pong"] + jnp.int32(0)})


class THonestBeater(TPP):
    TICK_INTERVAL = 1

    def tick_beat(self, net, state, t):
        return state._replace(proto={"pong": state.proto["pong"] + 0})


class JStaleCache(JPP):
    # declares pong_total derived but never updates it
    DERIVED_CACHE_LEAVES = ("pong_total",)

    def recompute_caches(self, state):
        return {"pong_total": jnp.sum(state.proto["pong"])[None].astype(jnp.int32)}

    def deliver(self, net, state, deliver_mask):
        carried = state.proto["pong_total"]
        state, em = super().deliver(net, state, deliver_mask)
        return state._replace(proto=dict(state.proto, pong_total=carried)), em


class TStaleCache(TPP):
    DERIVED_CACHE_LEAVES = ("pong_total",)

    def recompute_caches(self, state):
        return {"pong_total": state.proto["pong"].sum(-1, keepdim=True).to(torch.int32)}

    def deliver(self, net, state, deliver_mask, t):
        carried = state.proto["pong_total"]
        state, em = super().deliver(net, state, deliver_mask, t)
        return state._replace(proto=dict(state.proto, pong_total=carried)), em


DEFECTS = {
    # name: (JAX class, port class, the rule that must fire, message words)
    "SL401_dtype_drift": (JDriftingTick, TDriftingTick, "SL401", ()),
    "SL402_store_write": (JBadDeliver, TBadDeliver, "SL402", ("msg_valid",)),
    "SL406_fault_sensitive": (JFaultSensitive, TFaultSensitive, "SL406", ()),
    "SL407_fault_write": (JFaultWriter, TFaultWriter, "SL407", ("dropped_by_fault",)),
    "SL901_live_dtype": (JUnnarrowedInit, TUnnarrowedInit, "SL901", ("pong", "int32")),
    "SL901_headroom": (JNoSentinelRoom, TNoSentinelRoom, "SL901", ("127", "sentinel")),
    "SL1201_beating_jumper": (JLyingJumper, TLyingJumper, "SL1201", ("not a no-op",)),
    "SL1201_beat_period": (JPeriodicJumper, TPeriodicJumper, "SL1201", ("BEAT_PERIOD",)),
    "SL701_stale_cache": (JStaleCache, TStaleCache, "SL701", ("STALE",)),
}


@pytest.mark.parametrize("name", sorted(DEFECTS))
def test_seeded_defect_same_rules(name):
    jcls, tcls, rule, words = DEFECTS[name]
    caches = rule == "SL701"
    want = jcheck(_jentry(jcls, caches))
    got = tcheck(_tentry(tcls, caches), device="cpu")
    assert sorted({f.rule for f in got}) == sorted({f.rule for f in want}), (
        [f.format() for f in want], [f.format() for f in got])
    assert any(f.rule == rule and all(w in f.message for w in words) for f in got), \
        [f.message for f in got]


def test_sl1201_quiet_on_declared_tick_interval():
    """HonestBeater declares TICK_INTERVAL=1: neither package flags
    SL1201, and both give the same rules."""
    want = jcheck(_jentry(JHonestBeater))
    got = tcheck(_tentry(THonestBeater), device="cpu")
    assert not any(f.rule == "SL1201" for f in got)
    assert {f.rule for f in got} == {f.rule for f in want}


def test_sl405_beat_rng_mismatch_and_suppression():
    """A beat that lies about BEAT_SEND_CALLS is SL405 in both packages,
    the message naming the declaration; SIMLINT_SUPPRESS silences it in
    both."""

    class JBadBeat(JPP):
        BEAT_PERIOD = 5
        BEAT_RESIDUES = (0,)
        BEAT_SEND_CALLS = 2  # lies: tick_beat draws nothing

        def tick_beat(self, net, state):
            return state

    class TBadBeat(TPP):
        BEAT_PERIOD = 5
        BEAT_RESIDUES = (0,)
        BEAT_SEND_CALLS = 2

        def tick_beat(self, net, state, t):
            return state

    want = jaudit(_jentry(JBadBeat))
    got = taudit(_tentry(TBadBeat), device="cpu")
    assert [f.rule for f in got] == [f.rule for f in want] == ["SL405"]
    assert "BEAT_SEND_CALLS=2" in got[0].message

    class JSuppressed(JBadBeat):
        SIMLINT_SUPPRESS = ("SL405",)

    class TSuppressed(TBadBeat):
        SIMLINT_SUPPRESS = ("SL405",)

    assert jaudit(_jentry(JSuppressed)) == [] == taudit(_tentry(TSuppressed), device="cpu")
    # a dead declaration (no BEAT_PERIOD) is the JAX rule's second half

    class JDead(JPP):
        BEAT_SEND_CALLS = 1

    class TDead(TPP):
        BEAT_SEND_CALLS = 1

    want = jaudit(_jentry(JDead))
    got = taudit(_tentry(TDead), device="cpu")
    assert [f.rule for f in got] == [f.rule for f in want] == ["SL405"]
    assert "BEAT_PERIOD is unset" in got[0].message


def test_sl402_in_place_write_is_caught():
    """The port's passthrough test is the same tensor AND an unmoved
    version counter: a deliver that writes the store in place and hands
    the same tensor back is flagged (identity alone would pass it)."""

    class InPlace(TPP):
        def deliver(self, net, state, deliver_mask, t):
            state, em = super().deliver(net, state, deliver_mask, t)
            state.msg_arrival.add_(0)
            return state, em

    got = tcheck(_tentry(InPlace), device="cpu")
    assert any(f.rule == "SL402" and "msg_arrival" in f.message for f in got), \
        [f.format() for f in got]


class JStaleCommit(JHandel):
    # the commit moves the aggregates but keeps the pre-commit caches
    def _commit(self, net, state):
        before = {k: state.proto[k] for k in self.CACHE_LEAF_NAMES}
        state = super()._commit(net, state)
        return state._replace(proto={**state.proto, **before})


class TStaleCommit(THandel):
    def _commit(self, net, state, t):
        before = {k: state.proto[k] for k in self.CACHE_LEAF_NAMES}
        state = super()._commit(net, state, t)
        return state._replace(proto={**state.proto, **before})


def _swap_class(net, cls):
    net = copy.copy(net)
    proto = copy.copy(net.protocol)
    proto.__class__ = cls
    net.protocol = proto
    return net


STALE_AFTER_MS = 40  # the registry's Handel commits by then


def stale_handel_entry(device=None):
    """The port's registry Handel (score cache on), run STALE_AFTER_MS
    plain, then handed over with a commit that skips the cache update."""
    def factory(device=None):
        net, state = treg.get("handel").factory(device=device)
        one = map_state(lambda a: a.unsqueeze(0), state)
        state = map_state(lambda a: a[0], net.run_ms_batched(one, STALE_AFTER_MS))
        return _swap_class(net, TStaleCommit), state

    return TEntry("handel_stale_commit", "handel_batched", factory)


def test_sl701_stale_commit_handel():
    """Both packages' SL701 pass flags the stale commit after the same
    plain run; the port's whole check names SL701 alone, and the plain
    protocol on the same state is clean."""
    jnet, jstate = jreg.get("handel").factory()
    jstate = jnet.run_ms(jstate, STALE_AFTER_MS)
    want = jcheck_sl701(_cpu_jax(), "handel", _swap_class(jnet, JStaleCommit), jstate, "x", 1,
                        set())
    assert [f.rule for f in want] and {f.rule for f in want} == {"SL701"}
    got = tcheck(stale_handel_entry(), device="cpu")
    assert {f.rule for f in got} == {"SL701"}, [f.format() for f in got]
    assert {f.message.split("'")[1] for f in got} == {f.message.split("'")[1] for f in want}
    assert all("STALE" in f.message for f in got)
