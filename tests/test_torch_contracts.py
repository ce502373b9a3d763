"""The port's contract metadata and contract checks against the JAX package's.

The engine's contract metadata and Handel's, GSF's, HandelEth2's,
P2PHandel's and ENR's `contract()` equal the JAX package's, key for key
(test_torch_registries.py holds every entry's); the port's contract
checks find nothing over every registry entry on the CPU, and neither
do the JAX package's on PingPong, Handel and P2PHandel; Handel's and
P2PHandel's `recompute_caches` give the JAX package's leaves bitwise on
a state carried across by interop, and equal the carried caches there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wittgenstein_tpu.analysis.contracts import check_entry as jcheck
from wittgenstein_tpu.core.registries import registry_batched_protocols as jreg
from wittgenstein_tpu.engine.checkpoint import EPHEMERAL_LEAVES as J_EPHEMERAL
from wittgenstein_tpu.engine.protocol import ENGINE_OWNED_FIELDS as J_OWNED
from wittgenstein_tpu.engine.protocol import HOST_HOOKS as J_HOST
from wittgenstein_tpu.engine.protocol import KERNEL_HOOKS as J_KERNEL
from wittgenstein_tpu_torch import engine
from wittgenstein_tpu_torch.analysis.contracts import check_all, check_entry
from wittgenstein_tpu_torch.core.registries import registry_batched_protocols as treg
from wittgenstein_tpu_torch.engine.checkpoint import EPHEMERAL_LEAVES
from wittgenstein_tpu_torch.engine.core import SimState
from wittgenstein_tpu_torch.interop import state_to_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_metadata_matches():
    assert engine.ENGINE_OWNED_FIELDS == J_OWNED
    assert engine.KERNEL_HOOKS == J_KERNEL and engine.HOST_HOOKS == J_HOST
    assert set(J_OWNED) <= set(SimState._fields)
    assert EPHEMERAL_LEAVES == J_EPHEMERAL == frozenset()
    base = engine.BatchedProtocol()
    assert base.recompute_caches(None) == {}
    assert (base.DELIVER_MAY_TOUCH, base.SIMLINT_SUPPRESS, base.DERIVED_CACHE_LEAVES) == \
        ((), (), ())


# the entries whose JAX build is cheap once the file's others have run;
# test_torch_registries.py holds contract() over every entry
CONTRACT_ENTRIES = ["gsf", "handel", "handeleth2", "p2phandel", "enr"]


def test_contract_matches():
    """contract() key for key; the port's interop metadata (WORD_LEAVES,
    PROTO_KEYS) stays out of it."""
    for name in CONTRACT_ENTRIES:
        jnet, _ = jreg.get(name).factory()
        tnet, _ = treg.get(name).factory(device="cpu")
        want, got = jnet.protocol.contract(), tnet.protocol.contract()
        assert got == want, (name, {k: (want[k], got.get(k)) for k in want
                                    if want[k] != got.get(k)})
        assert "word_leaves" not in got and "proto_keys" not in got


def test_cache_leaves_follow_the_score_cache_arm():
    from wittgenstein_tpu_torch.protocols.handel import HandelParameters
    from wittgenstein_tpu_torch.protocols.handel_batched import BatchedHandel, make_handel
    from wittgenstein_tpu_torch.protocols.p2phandel_batched import BatchedP2PHandel

    for score_cache in (True, False):
        net, _ = make_handel(HandelParameters(node_count=32), score_cache=score_cache,
                             device="cpu")
        assert net.protocol.DERIVED_CACHE_LEAVES == (
            BatchedHandel.CACHE_LEAF_NAMES if score_cache else ())
    assert BatchedP2PHandel.CACHE_LEAF_NAMES == ("ver_card",)
    net, _ = treg.get("p2phandel").factory(device="cpu")
    assert net.protocol.DERIVED_CACHE_LEAVES == ("ver_card",)


def test_port_check_all_clean_on_cpu():
    findings = check_all(device="cpu")
    assert findings == [], "\n".join(f.format() for f in findings)


@pytest.mark.parametrize("name", ["pingpong", "handel", "p2phandel"])
def test_jax_check_entry_clean(name):
    """The JAX package's own checks on the three entries the port's are
    held beside (its checks trace; the port's step concretely)."""
    findings = jcheck(jreg.get(name))
    assert findings == [], "\n".join(f.format() for f in findings)
    assert check_entry(treg.get(name), device="cpu") == []


def _to_jax(jstate, snap: dict):
    """A numpy snapshot as the JAX package's SimState."""
    leaves = {}
    for f, v in snap.items():
        if f in ("tele", "faults") and isinstance(v, dict):
            v = type(getattr(jstate, f))(**v)
        empty = isinstance(v, tuple) and not v
        leaves[f] = v if empty else jax.tree_util.tree_map(jnp.asarray, v)
    return type(jstate)(**leaves)


@pytest.mark.parametrize("name, ms", [("handel", 80), ("p2phandel", 60)])
def test_recompute_caches_bitwise(name, ms):
    """The port runs the registry entry (score cache on) x 2 for `ms` ms,
    the state crosses to the JAX package by interop, and the port's
    recompute_caches equals the JAX package's (vmapped over the replicas)
    leaf for leaf, bitwise, and both equal the carried caches."""
    from wittgenstein_tpu_torch.engine import replicate_state

    jnet, jstate = jreg.get(name).factory()
    tnet, tstate = treg.get(name).factory(device="cpu")
    with torch.inference_mode():
        ts = tnet.run_ms_batched(replicate_state(tstate, 2), ms)
        got = {k: v.numpy() for k, v in tnet.protocol.recompute_caches(ts).items()}
    snap = state_to_numpy(ts)
    js = _to_jax(jstate, snap)
    want = {k: np.asarray(v) for k, v in jax.vmap(jnet.protocol.recompute_caches)(js).items()}
    leaves = jnet.protocol.DERIVED_CACHE_LEAVES
    assert leaves and set(want) == set(got) == set(leaves)
    for k in leaves:
        assert want[k].dtype == got[k].dtype and want[k].shape == got[k].shape, k
        assert np.array_equal(want[k], got[k]), k
        assert np.array_equal(snap["proto"][k], got[k]), f"{k}: carried != recomputed"
    # the caches are not trivial at this depth
    assert any(np.any(got[k] != got[k].flat[0]) for k in leaves)
