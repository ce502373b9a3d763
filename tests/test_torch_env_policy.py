"""`optimize_env_policy` on the port's attack environment against the JAX package's.

The same optimizers drive an in-protocol adversary: each replica of
`BatchedAttackEnv(n_replicas=4, decision_ms=200, horizon_ms=600, seed=0)`
(the registry's 64-node Handel) rolls out one candidate's silence
window, so a generation is one batched rollout.  After two ES
generations the port's `best_vec` and `best_score` equal the JAX
package's, and the recorder holds one `search-generation` event per
generation.
"""

import numpy as np
import pytest
import torch

from wittgenstein_tpu.protocols.handel_env import BatchedAttackEnv as JEnv
from wittgenstein_tpu.search import optimize_env_policy as jopt
from wittgenstein_tpu_torch.obs.recorder import FlightRecorder
from wittgenstein_tpu_torch.protocols.handel_env import BatchedAttackEnv as TEnv
from wittgenstein_tpu_torch.search import optimize_env_policy as topt

ENV = dict(n_replicas=4, decision_ms=200, horizon_ms=600, seed=0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_env_policy_equals_jax():
    want = jopt(JEnv(**ENV), generations=2, seed=0)
    rec = FlightRecorder()
    got = topt(TEnv(**ENV, device="cpu"), generations=2, seed=0, recorder=rec)
    assert got.best_score == want.best_score
    assert got.best_vec.dtype == want.best_vec.dtype and np.array_equal(got.best_vec,
                                                                         want.best_vec)
    assert got.state_meta() == want.state_meta()
    assert [e["gen"] for e in rec.events()] == [0, 1]
    assert rec.events()[-1]["champion_score"] == got.best_score


def test_sha_is_refused():
    with pytest.raises(ValueError, match="fixed population"):
        topt(object(), optimizer="sha")
