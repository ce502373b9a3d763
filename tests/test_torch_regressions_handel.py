"""The port's pinned Handel champion.

The port's `scenarios/regressions/handel_es_s0.json` is a byte copy of
the JAX package's pin (its ES campaign's champion over the registry's
64-node Handel at 1500 ms: no live node done, score 3000.0), and
replays in the port on the CPU to exactly that score, with the static
baselines re-scored to exactly the pinned values.  A replay whose
digest or score drifted fails with the JAX package's reason.
"""

import copy

import pytest
import torch

from wittgenstein_tpu_torch.scenarios import regressions as treg
from wittgenstein_tpu.scenarios import regressions as jreg

NAME = "handel_es_s0.json"


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def test_pin_is_a_byte_copy():
    assert (treg.REGRESSIONS_DIR / NAME).read_bytes() == \
        (jreg.REGRESSIONS_DIR / NAME).read_bytes()


def test_pin_replays_to_its_value():
    doc = treg.load_regression(treg.REGRESSIONS_DIR / NAME)
    out = treg.verify_regression(doc, device="cpu")
    assert out["objective_value"] == doc["objective_value"] == 3000.0
    assert out["plan_digest"] == doc["plan_digest"]
    assert out["record"]["availability"] == doc["availability"] == 0.0
    assert out["baseline_scores"] == doc["baseline"]["scores"]
    assert out["baseline_scores"] == {"control": 315.0, "crash20@200": 586.25, "drop30%": 334.0,
                                      "slow3x": 834.0, "split@100-600": 367.0}


def test_drift_fails_before_the_run():
    """A genome that no longer lowers to the pinned digest fails on the
    digest, before anything runs."""
    doc = copy.deepcopy(treg.load_regression(treg.REGRESSIONS_DIR / NAME))
    doc["plan_digest"] = "0" * 32
    with pytest.raises(AssertionError, match="lowered-plan digest drifted"):
        treg.verify_regression(doc, device="cpu")
