"""The port's error taxonomy against the JAX package's.

`classify` gives the JAX package's kind for every typed error and every
message of the JAX package's marker vocabulary (which the port keeps
word for word); the card's own vocabulary — `torch.cuda.OutOfMemoryError`,
the sticky context-loss messages, a device-side assert — maps to the
same kinds as their XLA counterparts, where the JAX package calls those
messages fatal; the per-kind counters count one per call.
"""

import pytest
import torch

from wittgenstein_tpu.runtime import errors as jerr
from wittgenstein_tpu_torch.runtime import errors as terr

TYPED = [
    ("DeviceLostError", ("gone",)),
    ("PreemptedError", ("sigterm",)),
    ("TransientRunError", ("flaky",)),
    ("FatalRunError", ("no",)),
    ("DurableRunError", ("base",)),
    ("ResumeMismatchError", ("other run",)),
    ("WatchdogTimeoutError", ("chunk", 1.0)),
    ("LaneFailedError", (2, "injected kill")),
    ("RunIncompleteError", ("budget",)),
]


def _both(name, args):
    return getattr(jerr, name)(*args), getattr(terr, name)(*args)


@pytest.mark.parametrize("name,args", TYPED, ids=[t[0] for t in TYPED])
def test_typed_errors_classify_as_jax(name, args):
    j, t = _both(name, args)
    assert terr.classify(t) == jerr.classify(j)
    assert str(t) == str(j)


def test_wrapped_errors_classify_as_jax():
    cause = ValueError("bad row")
    assert terr.classify(terr.PoisonRowError("job-1", cause)) == "poison_row"
    assert str(terr.PoisonRowError("job-1", cause)) == str(jerr.PoisonRowError("job-1", cause))
    last = RuntimeError("UNAVAILABLE: still down")
    t, j = terr.RetriesExhaustedError(3, last), jerr.RetriesExhaustedError(3, last)
    assert (terr.classify(t), str(t), t.attempts) == (jerr.classify(j), str(j), j.attempts)
    assert terr.classify(KeyboardInterrupt()) == jerr.classify(KeyboardInterrupt()) == "fatal"
    assert terr.classify(SystemExit()) == "fatal"


def test_vocabulary_is_the_jax_packages_word_for_word():
    assert terr._TRANSIENT_MARKERS == jerr._TRANSIENT_MARKERS
    assert terr._DEVICE_LOST_MARKERS == jerr._DEVICE_LOST_MARKERS
    assert terr.RETRYABLE_KINDS == jerr.RETRYABLE_KINDS


MARKERS = sorted(set(jerr._TRANSIENT_MARKERS) | set(jerr._DEVICE_LOST_MARKERS))


@pytest.mark.parametrize("marker", MARKERS)
@pytest.mark.parametrize("exc", [RuntimeError, OSError, ConnectionError])
def test_jax_vocabulary_classifies_as_jax(marker, exc):
    for text in (marker, marker.upper(), f"XLA: {marker.title()} while running chunk 3"):
        e = exc(text)
        assert terr.classify(e) == jerr.classify(e), text


@pytest.mark.parametrize("text", [
    "DEADLINE_EXCEEDED: rpc", "server UNAVAILABLE", "tpu is dead",
    "Connection reset by peer", "shape mismatch", "", "CUDA error: no kernel image",
])
def test_backend_messages_classify_as_jax(text):
    e = RuntimeError(text)
    assert terr.classify(e) == jerr.classify(e)


CARD = [
    (torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB (GPU 0; 79.10 GiB total)"),
     "transient"),
    (RuntimeError("CUDA out of memory. Tried to allocate 512.00 MiB"), "transient"),
    (RuntimeError("CUDA error: an illegal memory access was encountered\nCUDA kernel "
                  "errors might be asynchronously reported at some other API call"),
     "device_lost"),
    (RuntimeError("CUDA error: unspecified launch failure"), "device_lost"),
    (RuntimeError("CUDA error: uncorrectable ECC error encountered"), "device_lost"),
    (RuntimeError("Unable to determine the device handle for GPU0: GPU has fallen off "
                  "the bus"), "device_lost"),
    (RuntimeError("CUDA error: device-side assert triggered\nCompile with "
                  "`TORCH_USE_CUDA_DSA` to enable device-side assertions."), "fatal"),
]


@pytest.mark.parametrize("exc,kind", CARD, ids=[k + str(i) for i, (_, k) in enumerate(CARD)])
def test_card_vocabulary(exc, kind):
    """The card's errors get the kinds of their XLA counterparts
    (RESOURCE_EXHAUSTED, a lost device, a semantic failure); the JAX
    package, which has no such vocabulary, calls each of them fatal."""
    assert terr.classify(exc) == kind
    assert jerr.classify(exc) == "fatal"
    assert (kind in terr.RETRYABLE_KINDS) == (kind != "fatal")


def test_accelerator_error_reads_its_message():
    """torch raises CUDA failures as AcceleratorError where it has one."""
    cls = getattr(torch, "AcceleratorError", RuntimeError)
    try:
        e = cls("CUDA error: an illegal memory access was encountered")
    except TypeError:  # a constructor that wants an error code too
        e = RuntimeError("CUDA error: an illegal memory access was encountered")
    assert terr.classify(e) == "device_lost"


def test_taxonomy_counters_count_per_classify():
    terr.reset_taxonomy_counters()
    jerr.reset_taxonomy_counters()
    cases = [terr.PoisonRowError("j", ValueError("x")), terr.DeviceLostError("gone"),
             RuntimeError("server UNAVAILABLE"), terr.LaneFailedError(0), ValueError("x"),
             RuntimeError("server UNAVAILABLE")]
    for e in cases:
        terr.classify(e)
        jerr.classify(e if not isinstance(e, terr.DurableRunError)
                      else getattr(jerr, type(e).__name__)(*_args(e)))
    assert terr.taxonomy_counters() == jerr.taxonomy_counters() == {
        "poison_row": 1, "device_lost": 1, "transient": 2, "lane_failed": 1, "fatal": 1}
    terr.reset_taxonomy_counters()
    jerr.reset_taxonomy_counters()
    assert terr.taxonomy_counters() == {}


def _args(e):
    if isinstance(e, terr.PoisonRowError):
        return (e.job_id, e.cause)
    if isinstance(e, terr.LaneFailedError):
        return (e.lane,)
    return e.args
