"""The port's supervisor policies against the JAX package's.

RetryPolicy.delay_s gives the JAX package's floats exactly (a blake2b
hash of seed and attempt); the policies' defaults are the JAX package's;
the WatchdogWorker reuses one thread across calls, joins it on close,
abandons a hung one and never reuses it, and runs each call under the
caller's grad and inference mode.  Thread counts here are of the
worker's own named threads only.
"""

import dataclasses
import threading
import time

import pytest
import torch

from wittgenstein_tpu.runtime import policy as jpol
from wittgenstein_tpu_torch.runtime import WatchdogTimeoutError, run_with_deadline
from wittgenstein_tpu_torch.runtime import policy as tpol

RETRY_SETTINGS = [
    {},
    dict(backoff_base_s=0.5, backoff_factor=2.0, backoff_max_s=4.0, jitter_frac=0.25, seed=7),
    dict(backoff_base_s=0.1, backoff_factor=3.0, backoff_max_s=1e9, jitter_frac=0.9, seed=123456),
    dict(jitter_frac=0.0, seed=5),
    dict(backoff_base_s=2.0, backoff_factor=1.5, seed=2**40 + 3),
]


@pytest.mark.parametrize("kw", RETRY_SETTINGS, ids=[str(i) for i in range(len(RETRY_SETTINGS))])
def test_delay_s_equals_jax_float_for_float(kw):
    t, j = tpol.RetryPolicy(**kw), jpol.RetryPolicy(**kw)
    for attempt in range(12):
        assert t.delay_s(attempt) == j.delay_s(attempt), attempt
    for seed in range(64):
        assert (dataclasses.replace(t, seed=seed).delay_s(1)
                == dataclasses.replace(j, seed=seed).delay_s(1))


def test_delays_bounded_and_seeded():
    p = tpol.RetryPolicy(backoff_base_s=0.5, backoff_factor=2.0, backoff_max_s=4.0,
                         jitter_frac=0.25, seed=7)
    for k in range(6):
        base = min(4.0, 0.5 * 2.0**k)
        assert base * 0.75 <= p.delay_s(k) <= base * 1.25
    assert tpol.RetryPolicy(seed=0).delay_s(1) != tpol.RetryPolicy(seed=1).delay_s(1)


@pytest.mark.parametrize("name", ["RetryPolicy", "WatchdogPolicy", "SalvagePolicy",
                                  "DegradePolicy"])
def test_policy_defaults_equal_jax(name):
    assert dataclasses.asdict(getattr(tpol, name)()) == dataclasses.asdict(getattr(jpol, name)())
    with pytest.raises(dataclasses.FrozenInstanceError):
        setattr(getattr(tpol, name)(), dataclasses.fields(getattr(tpol, name))[0].name, 1)


def _named(name: str) -> list:
    return [t for t in threading.enumerate() if t.name == name]


def test_one_thread_reused_across_calls():
    w = tpol.WatchdogWorker(name="witt-test-reuse")
    idents = {w.call(threading.get_ident, 5.0, "chunk") for _ in range(5)}
    assert len(idents) == 1 and threading.get_ident() not in idents
    assert len(_named("witt-test-reuse")) == 1
    assert w.close()
    assert _named("witt-test-reuse") == []


def test_close_without_calls_and_twice():
    w = tpol.WatchdogWorker(name="witt-test-idle")
    assert w.close() and w.close()
    assert w.call(lambda: 3, 5.0, "chunk") == 3  # a closed worker starts a new thread
    assert w.close()
    assert _named("witt-test-idle") == []


def test_exception_propagates_and_worker_survives():
    w = tpol.WatchdogWorker(name="witt-test-err")

    def boom():
        raise ValueError("inner")

    with pytest.raises(ValueError, match="inner"):
        w.call(boom, 5.0, "chunk")
    assert w.call(lambda: 2, 5.0, "chunk") == 2
    assert w.close()


def test_hung_worker_abandoned_never_reused():
    ev = threading.Event()
    w = tpol.WatchdogWorker(name="witt-test-hung")
    with pytest.raises(WatchdogTimeoutError) as ei:
        w.call(lambda: ev.wait(30), 0.05, "chunk")
    assert ei.value.phase == "chunk" and ei.value.deadline_s == 0.05
    assert w.hung
    with pytest.raises(RuntimeError, match="hung"):
        w.call(lambda: 2, 5.0, "chunk")
    th = w._thread
    assert w.close() is False  # abandoned, not joined
    ev.set()  # the stuck call returns; the pre-queued sentinel ends the thread
    th.join(5.0)
    assert not th.is_alive()
    assert _named("witt-test-hung") == []


def test_run_with_deadline():
    assert run_with_deadline(lambda: 41 + 1, 5.0, "chunk") == 42
    ev = threading.Event()
    with pytest.raises(WatchdogTimeoutError) as ei:
        run_with_deadline(lambda: ev.wait(30), 0.05, "compile+chunk")
    ev.set()
    assert ei.value.phase == "compile+chunk"
    deadline = time.monotonic() + 5.0
    while _named("witt-compile+chunk") and time.monotonic() < deadline:
        time.sleep(0.01)
    assert _named("witt-compile+chunk") == []


def _modes():
    return torch.is_inference_mode_enabled(), torch.is_grad_enabled()


@pytest.mark.parametrize("mode", ["default", "no_grad", "inference"])
def test_calls_run_under_the_callers_autograd_mode(mode):
    ctx = {"default": torch.enable_grad, "no_grad": torch.no_grad,
           "inference": torch.inference_mode}[mode]
    w = tpol.WatchdogWorker(name="witt-test-mode")
    with ctx():
        want = _modes()
        assert w.call(_modes, 5.0, "chunk") == want
        x = torch.zeros(3)
    # an in-place update of a tensor made under inference mode works on
    # the worker only under inference mode, as on the caller's thread
    if mode == "inference":
        with torch.inference_mode():
            w.call(lambda: x.add_(1), 5.0, "chunk")
        assert x.tolist() == [1.0, 1.0, 1.0]
    assert w.call(_modes, 5.0, "chunk") == _modes()  # outside: the default again
    assert w.close()
