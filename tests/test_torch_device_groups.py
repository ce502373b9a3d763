"""The port's device groups (parallel/device_groups.py) against the JAX
package's.

`make_device_groups` raises the JAX package's errors, word for word,
for the same counts; the labels of one-device groups are the JAX
package's; placement commits every leaf to the group's device over an
explicit CPU device list, bytes unchanged, from a state or from the
host tree the Supervisor hands a placement.  The default device list is
every visible CUDA device (none here), and a group of more than one
device, or with node_parallel > 1, has the JAX package's mesh shape,
label and layout geometry.
"""

import jax
import numpy as np
import pytest
import torch

from wittgenstein_tpu.parallel import device_groups as jdg
from wittgenstein_tpu_torch.engine import replicate_state
from wittgenstein_tpu_torch.interop import state_to_numpy
from wittgenstein_tpu_torch.parallel import device_groups as tdg
from wittgenstein_tpu_torch.protocols.pingpong_batched import make_pingpong

CPU = torch.device("cpu")


def _message(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("n_groups,n_devices,node_parallel", [
    (0, 4, 1), (-1, 2, 1), (3, 2, 1), (3, 8, 1), (2, 0, 1), (4, 4, 0), (2, 4, 3),
])
def test_errors_equal_jax(n_groups, n_devices, node_parallel):
    want = _message(lambda: jdg.make_device_groups(
        n_groups, devices=[f"d{i}" for i in range(n_devices)], node_parallel=node_parallel))
    got = _message(lambda: tdg.make_device_groups(
        n_groups, devices=[CPU] * n_devices, node_parallel=node_parallel))
    assert want is not None
    assert got == want


@pytest.mark.parametrize("n_groups", [1, 2, 4])
def test_labels_equal_jax(n_groups):
    jg = jdg.make_device_groups(n_groups, devices=[f"d{i}" for i in range(n_groups)])
    tg = tdg.make_device_groups(n_groups, devices=[CPU] * n_groups)
    assert [g.label() for g in tg] == [g.label() for g in jg]
    assert [g.index for g in tg] == [g.index for g in jg]
    assert all(g.devices == (CPU,) and g.replica_parallel == 1 for g in tg)


def test_placement_keeps_every_leaf():
    net, s = make_pingpong(16, device="cpu")
    states = replicate_state(s, 3)
    (group,) = tdg.make_device_groups(1, devices=["cpu"])
    placed = group.place(states, net=net)
    want = state_to_numpy(states)
    for tree in (placed, group.place(want)):  # a state, the Supervisor's host tree
        got = state_to_numpy(tree)
        for k, v in want.items():
            if isinstance(v, dict):
                for kk, vv in v.items():
                    assert np.array_equal(got[k][kk], vv), (k, kk)
            elif isinstance(v, np.ndarray):
                assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
        assert tree.time.device == CPU


def test_default_devices_are_cuda_and_multi_device_waits():
    """The default device list is every visible CUDA device; a group of
    several devices, or with node_parallel > 1, has the JAX package's
    mesh, layout and sharding over its devices."""
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no devices visible"):
            tdg.make_device_groups(1)
    jg = jdg.make_device_groups(1, devices=jax.devices()[:2])[0]
    (pair,) = tdg.make_device_groups(1, devices=[CPU, CPU])
    assert pair.label() == jg.label() == "group0[2dev]"
    assert pair.mesh.devices.shape == jg.mesh.devices.shape == (2,)
    assert pair.layout().geometry() == jg.layout().geometry()
    assert pair.sharding().replica_axis == "replicas" and pair.sharding().node_axis is None
    jg2 = jdg.make_device_groups(1, devices=jax.devices()[:2], node_parallel=2)[0]
    (pair2,) = tdg.make_device_groups(1, devices=[CPU, CPU], node_parallel=2)
    assert pair2.label() == jg2.label() == "group0[1x2]"
    assert pair2.mesh.devices.shape == jg2.mesh.devices.shape == (1, 2)
    assert pair2.layout().geometry() == jg2.layout().geometry()
    (group,) = tdg.make_device_groups(1, devices=[CPU])
    assert group.layout().geometry() == jdg.make_device_groups(
        1, devices=jax.devices()[:1])[0].layout().geometry()
