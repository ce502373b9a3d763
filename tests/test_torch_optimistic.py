"""Batched OptimisticP2PSignature in the port against the JAX package.

Every node's signature floods the P2P graph (built on the host from the
oracle's JavaRandom stream) on the flat store; a node is done at
`threshold` signatures, and a done node neither records nor forwards.
The lowest-slot winner per (node, signature) decides which row forwards.
Every leaf after 1500 ms must equal the JAX package's at the JAX tests'
base (64 nodes, threshold 56, 10 connections), with pairing times 1 and
10, and the port's winner, scattered from the delivered rows only, must
pick the rows JAX's dense `[N, N]` winner table picks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_paxos import assert_same_state, jax_numpy
from wittgenstein_tpu.engine import replicate_state as jreplicate
from wittgenstein_tpu.protocols.optimistic_p2p_signature import (
    OptimisticP2PSignatureParameters as JParams,
)
from wittgenstein_tpu.protocols.optimistic_p2p_signature_batched import make_optimistic as jmake
from wittgenstein_tpu_torch.engine import replicate_state as treplicate
from wittgenstein_tpu_torch.interop import state_to_numpy
from wittgenstein_tpu_torch.ops.indexing import first_in_cell
from wittgenstein_tpu_torch.protocols.optimistic_p2p_signature import (
    OptimisticP2PSignatureParameters as TParams,
)
from wittgenstein_tpu_torch.protocols.optimistic_p2p_signature_batched import (
    make_optimistic as tmake,
)

REPLICAS = 2
SIM_MS = 1500
BASE = dict(node_count=64, threshold=56, connection_count=10)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("pairing_time", [1, 10])
def test_signatures_match(pairing_time):
    kw = dict(BASE, pairing_time=pairing_time)
    jnet, jstate = jmake(JParams(**kw))
    tnet, tstate = tmake(TParams(**kw), device="cpu")
    adj = tnet.protocol.adj.numpy()
    assert adj.dtype == np.int32 and np.array_equal(adj, np.asarray(jnet.protocol.adj))
    assert_same_state(jax_numpy(jreplicate(jstate, 1)), state_to_numpy(treplicate(tstate, 1)),
                      "initial state")
    want = jax_numpy(jnet.run_ms_batched(jreplicate(jstate, REPLICAS), SIM_MS))
    got = state_to_numpy(tnet.run_ms_batched(treplicate(tstate, REPLICAS), SIM_MS))
    assert_same_state(want, got, f"pairing_time {pairing_time}")
    assert (got["done_at"] > 0).all() and (got["dropped"] == 0).all()
    # a done node records nothing more: at most threshold + the same tick's
    assert (got["proto"]["received"].sum(-1) >= BASE["threshold"]).all()


def test_winner_matches_dense_table():
    """first_in_cell over random delivery views with repeated (node,
    signature) pairs against the JAX package's `winner.at[to, sig].min`
    table and its `winner[to, sig] == slot` test."""
    rng = np.random.RandomState(3)
    n, c, r = 12, 300, 3
    to = rng.randint(0, n, size=(r, c)).astype(np.int32)
    sig = rng.randint(0, n, size=(r, c)).astype(np.int32)
    fresh = rng.rand(r, c) < 0.6
    cell = torch.from_numpy(to).long() * n + torch.from_numpy(sig)
    got = first_in_cell(cell, torch.from_numpy(fresh), n * n).numpy()
    slot = jnp.arange(c, dtype=jnp.int32)
    for i in range(r):
        winner = jnp.full((n, n), c, jnp.int32)
        winner = winner.at[to[i], sig[i]].min(jnp.where(fresh[i], slot, c), mode="drop")
        want = fresh[i] & np.asarray(winner[to[i], sig[i]] == slot)
        assert np.array_equal(got[i], want)
    assert got.sum() < fresh.sum()  # repeated pairs lost their races
