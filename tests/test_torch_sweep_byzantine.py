"""The port's sweep runner on the Handel Byzantine battery against the
JAX package's.

`byzantine_configs` (0-50% byzantineSuicide) at 32 nodes x 2 replicas
with stop_when_done: the threshold differs at every fraction and is a
traced parameter, so run_sweep runs six groups, each on its first
config's engine, and gives the JAX package's BasicStats.  BASELINE
config 3's list (0-25% at 4096 nodes) forms six groups in both packages.
"""

import pytest
import torch

from wittgenstein_tpu.scenarios import handel_scenarios as jsc
from wittgenstein_tpu.scenarios import sweep as jsweep
from wittgenstein_tpu_torch.scenarios import handel_scenarios as tsc
from wittgenstein_tpu_torch.scenarios import sweep as tsweep


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_byzantine_battery_matches():
    want = jsweep.run_sweep(jsc.byzantine_configs(32), replicas=2, sim_ms=900, seed0=3,
                            stop_when_done=True)
    got = tsweep.run_sweep(tsc.byzantine_configs(32), replicas=2, sim_ms=900, seed0=3,
                           stop_when_done=True, device="cpu")
    assert [g.row() for g in got] == [w.row() for w in want]
    assert all(g.done_at_min > 0 for g in got)
    assert got[-1].done_at_avg > got[0].done_at_avg


def test_config3_forms_six_groups():
    """BASELINE config 3's list splits into one group a fraction (the
    threshold is traced), in both packages."""
    def groups(m):
        cfgs = [m.SweepConfig("byzSuicide", dr, m.default_params(
            4096, dead_ratio=dr, byzantine_suicide=dr > 0)) for dr in (0, .05, .1, .15, .2, .25)]
        return len({m._group_key(c.params) for c in cfgs})

    assert groups(tsweep) == groups(jsweep) == 6
    assert tsweep._STATE_ONLY_FIELDS == jsweep._STATE_ONLY_FIELDS
