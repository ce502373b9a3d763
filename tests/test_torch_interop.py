"""The interop round trip keeps every protocol's JAX dtypes.

`state_from_numpy` takes a JAX-package state into the port (uint32 words
as int32 bit views) and `state_to_numpy` gives it back; which leaves are
words is each protocol's own `WORD_LEAVES`, found from the state's proto
keys (`PROTO_KEYS`, declared by the protocols that carry words).  For every ported protocol the
round trip must give back the JAX state exactly — name, dtype, shape and
bits — including SanFermin's int32 `agg` (a word in Handel), HandelEth2's
uint32 words, P2PHandel's bool `ver_sig` (a word in Handel and GSF), and
the states of CasperIMD, Paxos, Slush, Snowflake, P2PFlood,
OptimisticP2PSignature, SanFerminCappos and ENRGossiping (its 0-d
`last_t` included), which hold no words.
"""

import jax
import numpy as np
import pytest

from wittgenstein_tpu.protocols.casper import CasperParameters
from wittgenstein_tpu.protocols.casper_batched import make_casper as jcasper
from wittgenstein_tpu.protocols.dfinity_batched import make_dfinity as jdfinity
from wittgenstein_tpu.protocols.enr_batched import make_enr as jenr
from wittgenstein_tpu.protocols.enr_gossiping import ENRParameters
from wittgenstein_tpu.protocols.gsf import GSFSignatureParameters
from wittgenstein_tpu.protocols.gsf_batched import make_gsf as jgsf
from wittgenstein_tpu.protocols.handel import HandelParameters
from wittgenstein_tpu.protocols.handel_batched import make_handel as jhandel
from wittgenstein_tpu.protocols.handeleth2 import HandelEth2Parameters
from wittgenstein_tpu.protocols.handeleth2_batched import make_handeleth2 as jeth2
from wittgenstein_tpu.protocols.p2phandel import P2PHandelParameters
from wittgenstein_tpu.protocols.p2phandel_batched import make_p2phandel as jp2p
from wittgenstein_tpu.protocols.paxos_batched import make_paxos as jpaxos
from wittgenstein_tpu.protocols.pingpong_batched import make_pingpong as jpingpong
from wittgenstein_tpu.protocols.sanfermin import SanFerminSignatureParameters
from wittgenstein_tpu.protocols.sanfermin_batched import make_sanfermin as jsanfermin
from wittgenstein_tpu.protocols.avalanche_batched import make_slush as jslush
from wittgenstein_tpu.protocols.avalanche_batched import make_snowflake as jsnowflake
from wittgenstein_tpu.protocols.optimistic_p2p_signature import OptimisticP2PSignatureParameters
from wittgenstein_tpu.protocols.optimistic_p2p_signature_batched import make_optimistic as jopt
from wittgenstein_tpu.protocols.p2pflood import P2PFloodParameters
from wittgenstein_tpu.protocols.p2pflood_batched import make_p2pflood as jflood
from wittgenstein_tpu.protocols.sanfermin_cappos import SanFerminParameters
from wittgenstein_tpu.protocols.sanfermin_cappos_batched import make_sanfermin_cappos as jcappos
from wittgenstein_tpu_torch.interop import (
    ported_protocols,
    protocol_of,
    state_from_numpy,
    state_to_numpy,
)

# name: (JAX builder, the port's protocol class name, words the JAX state holds);
# the class is the one protocol_of finds, None for a protocol without words
BUILDS = {
    "handel": (lambda: jhandel(HandelParameters(node_count=64, threshold=63)),
               "BatchedHandel", {"agg", "ind", "inc", "ver_sig", "in_sig0", "cand_sig0"}),
    "handel_byzantine": (
        lambda: jhandel(HandelParameters(node_count=64, nodes_down=16, threshold=47,
                                         byzantine_suicide=True)),
        "BatchedHandel", {"agg", "ind", "inc", "ver_sig", "in_sig0", "cand_sig0", "bl", "byz"}),
    "gsf": (lambda: jgsf(GSFSignatureParameters(node_count=64)), "BatchedGSF",
            {"ver", "indiv", "ind_seen", "pend_ind", "ver_sig", "in_sig0", "cand_sig0"}),
    "p2phandel": (lambda: jp2p(P2PHandelParameters(
        signing_node_count=24, relaying_node_count=8, connection_count=6)),
        None, set()),
    "pingpong": (lambda: jpingpong(64), None, set()),
    "dfinity": (jdfinity, None, set()),
    "handeleth2": (lambda: jeth2(HandelEth2Parameters(node_count=16)), "BatchedHandelEth2",
                   {"fin_peers", "inc", "ind", "out", "c_atts", "v_atts"}),
    "sanfermin": (lambda: jsanfermin(SanFerminSignatureParameters(
        64, 64, 2, 48, 300, 1, False, None, None)), "BatchedSanFermin", {"pending"}),
    # no words: protocol_of must identify neither as another protocol
    "casper": (lambda: jcasper(CasperParameters(), max_heights=16, byz_variant="sf"), None,
               set()),
    "paxos": (jpaxos, None, set()),
    # bool and int32 leaves only, no words
    "slush": (jslush, None, set()),
    "snowflake": (jsnowflake, None, set()),
    "p2pflood": (lambda: jflood(P2PFloodParameters(msg_count=3)), None, set()),
    "optimistic": (lambda: jopt(OptimisticP2PSignatureParameters(64, 56, 10, 1)), None, set()),
    "sanfermin_cappos": (lambda: jcappos(SanFerminParameters(64, 32, 2, 48, 150, 4)), None,
                         set()),
    # bool and int32 leaves, with the 0-d clock last_t
    "enr": (lambda: jenr(ENRParameters(), horizon_ms=4_000_000), None, set()),
}


def jax_numpy(state) -> dict:
    d = jax.tree_util.tree_map(np.asarray, state)._asdict()
    d["proto"] = dict(d["proto"])
    return d


@pytest.mark.parametrize("name", list(BUILDS))
def test_round_trip_keeps_jax_dtypes(name):
    build, cls_name, words = BUILDS[name]
    _, jstate = build()
    want = jax_numpy(jstate)
    assert {k for k, v in want["proto"].items() if v.dtype == np.uint32} == words
    ts = state_from_numpy(want, "cpu")
    cls = protocol_of(ts.proto)
    assert (cls and cls.__name__) == cls_name
    got = state_to_numpy(ts)
    assert set(got) == set(want)
    for f, w in want.items():
        if f == "proto":
            assert set(got[f]) == set(w)
            for k, v in w.items():
                g = got[f][k]
                assert g.dtype == v.dtype and g.shape == v.shape, f"{name}: proto.{k}"
                assert np.array_equal(g, v), f"{name}: proto.{k}"
        elif isinstance(w, np.ndarray):
            assert got[f].dtype == w.dtype and np.array_equal(got[f], w), f"{name}: {f}"
    # every word leaf is an int32 bit view inside the port
    assert all(str(ts.proto[k].dtype) == "torch.int32" for k in words)
    if name == "enr":  # a single state's clock of the last step is 0-d
        assert got["proto"]["last_t"].shape == () and got["proto"]["last_t"] == -1


def test_every_ported_protocol_declares_its_state():
    """Each ported protocol with word leaves names the proto keys that
    identify its state, and no two protocols' keys identify the same
    state; a protocol without words declares no keys."""
    classes = ported_protocols()
    assert len(classes) == 14
    assert sum(bool(c.WORD_LEAVES) for c in classes) == 4  # Handel, GSF, HandelEth2, SanFermin
    for cls in classes:
        assert bool(cls.PROTO_KEYS) == bool(cls.WORD_LEAVES), cls.__name__
        if cls.PROTO_KEYS:
            assert protocol_of(cls.PROTO_KEYS) is cls
    assert protocol_of(["pong_count", "x"]) is None  # a probe protocol: no words


def test_fault_side_car_round_trip():
    """A JAX state carrying a FaultState (here a two-replica lower_plans
    stack, one row neutral) crosses into the port's FaultState and comes
    back as the dict of its leaves, dtype for dtype."""
    from wittgenstein_tpu.engine import replicate_state
    from wittgenstein_tpu.faults import FaultConfig, FaultPlan, lower_plans
    from wittgenstein_tpu_torch.faults import FaultState

    net, state = jpingpong(16)
    fs = lower_plans([None, FaultPlan("x").crash([1, 2], at=5).drop(300).silence([3])], 16,
                     net.protocol.n_msg_types())
    _, jstate = net.with_faults(replicate_state(state, 2), FaultConfig(), fs)
    want = jax_numpy(jstate)
    ts = state_from_numpy(want, "cpu")
    assert isinstance(ts.faults, FaultState)
    got = state_to_numpy(ts)
    assert set(got["faults"]) == set(want["faults"]._fields)
    for k, v in want["faults"]._asdict().items():
        assert got["faults"][k].dtype == v.dtype and np.array_equal(got["faults"][k], v), k


@pytest.mark.parametrize("wheel_rows", [None, 0], ids=["wheel", "flat"])
def test_telemetry_side_car_round_trip(wheel_rows):
    """A JAX state carrying a TelemetryState (PingPong 40 ms into a run
    with a snapshot ring, on the wheel and on the flat store, counters
    and ring written) crosses into the port's TelemetryState and comes
    back as the dict of its leaves, dtype for dtype; the port then runs
    on from it."""
    from wittgenstein_tpu.engine import replicate_state
    from wittgenstein_tpu.telemetry import TelemetryConfig
    from wittgenstein_tpu_torch.protocols.pingpong_batched import make_pingpong as tmake
    from wittgenstein_tpu_torch.telemetry import TelemetryConfig as TConfig
    from wittgenstein_tpu_torch.telemetry import TelemetryState

    cfg = dict(snapshots=8, snapshot_every_ms=10)
    net, state = jpingpong(16, wheel_rows=wheel_rows, telemetry=TelemetryConfig(**cfg))
    jstate = net.run_ms_batched(replicate_state(state, 2), 40)
    want = jax_numpy(jstate)
    assert int(np.asarray(jstate.tele.ticks).min()) > 0
    ts = state_from_numpy(want, "cpu")
    assert isinstance(ts.tele, TelemetryState) and ts.faults == ()
    got = state_to_numpy(ts)
    assert set(got["tele"]) == set(want["tele"]._fields)
    for k, v in want["tele"]._asdict().items():
        assert got["tele"][k].dtype == v.dtype and np.array_equal(got["tele"][k], v), k
    tnet, _ = tmake(16, wheel_rows=wheel_rows, telemetry=TConfig(**cfg), device="cpu")
    out = tnet.run_ms_batched(ts, 20)
    assert (out.tele.ticks >= ts.tele.ticks).all()


def test_ethpow_state_round_trip():
    """ETHPoW's state (the JAX package's dataclass, no proto and no store)
    crosses both ways leaf for leaf."""
    import dataclasses

    from wittgenstein_tpu.protocols.ethpow import ETHPoWParameters
    from wittgenstein_tpu.protocols.ethpow_batched import BatchedEthPow, replicate_ethpow
    from wittgenstein_tpu_torch.protocols.ethpow_batched import EthPowState

    net = BatchedEthPow(ETHPoWParameters(number_of_miners=4, byz_class_name="ETHSelfishMiner",
                                         byz_mining_ratio=0.3), b_max=16)
    jstate = jax.tree_util.tree_map(np.asarray, replicate_ethpow(net.init_state(), 3))
    ts = state_from_numpy(jstate, "cpu")
    assert isinstance(ts, EthPowState)
    got = state_to_numpy(ts)
    assert list(got) == [f.name for f in dataclasses.fields(jstate)]
    for k, v in got.items():
        w = getattr(jstate, k)
        assert v.dtype == w.dtype and v.shape == w.shape and np.array_equal(v, w), k
