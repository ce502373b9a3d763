"""Supervisor policies: retry/backoff, watchdog deadlines, degradation,
plus the WatchdogWorker that executes guarded calls.

The policies are frozen dataclasses so they hash and compare cleanly and
can be stamped into run provenance.  Backoff jitter is deterministic
(hashed from seed + attempt, as the JAX package hashes it): a resumed
supervisor replays the same delays, and tests pin exact delay sequences
without mocking random.
"""

from __future__ import annotations

import hashlib
import queue
import threading
from dataclasses import dataclass
from typing import Any, Callable

import torch

from .errors import WatchdogTimeoutError


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff + deterministic jitter.

    attempt n (0-based retry count) sleeps
      min(backoff_max_s, backoff_base_s * backoff_factor**n) * (1 ± jitter)
    where jitter is a hash of (seed, n) in [-jitter_frac, +jitter_frac].
    max_attempts counts executions, not retries: 3 means one initial try
    plus two retries.
    """

    max_attempts: int = 3
    backoff_base_s: float = 0.5
    backoff_factor: float = 2.0
    backoff_max_s: float = 30.0
    jitter_frac: float = 0.25
    seed: int = 0

    def delay_s(self, attempt: int) -> float:
        """Backoff delay before retry number `attempt` (0-based)."""
        base = min(
            self.backoff_max_s,
            self.backoff_base_s * (self.backoff_factor ** attempt),
        )
        if self.jitter_frac <= 0:
            return base
        h = hashlib.blake2b(
            f"{self.seed}:{attempt}".encode(), digest_size=8
        ).digest()
        unit = int.from_bytes(h, "big") / float(1 << 64)  # [0, 1)
        return base * (1.0 + self.jitter_frac * (2.0 * unit - 1.0))


@dataclass(frozen=True)
class WatchdogPolicy:
    """Per-phase deadlines.  A chunk that misses its deadline is treated
    as a hung device and raises WatchdogTimeoutError; the first chunk of
    a process gets compile_deadline_s on top of chunk_deadline_s (on the
    card, the kernels' build and load happen inside the first call)."""

    chunk_deadline_s: float = 180.0
    compile_deadline_s: float = 780.0


class WatchdogWorker:
    """Persistent deadline-guarded executor: one worker thread reused
    across every guarded call of a run, joined on completion, so the
    thread count is stable across a supervised run.

    Each call runs under the calling thread's autograd mode: grad mode
    and inference mode are thread-local in torch, so a run started under
    `torch.inference_mode()` keeps it on the worker (its states are
    inference tensors, which may not be updated in place outside it).

    Python cannot cancel a call that truly hangs.  A deadline miss marks
    the worker `hung`; it is abandoned (daemonic, never reused: the
    whole worker, result queue included, is discarded) and the caller
    builds a replacement.
    """

    def __init__(self, name: str = "witt-watchdog"):
        self._name = name
        self._requests: "queue.Queue" = queue.Queue()
        self._results: "queue.Queue" = queue.Queue()
        self._thread: threading.Thread | None = None
        self.hung = False

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name=self._name
            )
            self._thread.start()

    def _loop(self) -> None:
        while True:
            fn = self._requests.get()
            if fn is None:
                return
            try:
                self._results.put(("ok", fn()))
            except BaseException as e:  # noqa: BLE001 — forwarded to caller
                self._results.put(("err", e))

    def call(self, fn: Callable[[], Any], deadline_s: float, phase: str):
        """Run fn() on the worker, under the caller's grad and inference
        mode, with a deadline; raise WatchdogTimeoutError(phase) on a
        miss (and mark the worker hung: callers discard it)."""
        if self.hung:
            raise RuntimeError(
                f"WatchdogWorker {self._name!r} is hung; build a new one"
            )
        inference = torch.is_inference_mode_enabled()
        grad = torch.is_grad_enabled()

        def guarded():
            with torch.inference_mode(inference), torch.set_grad_enabled(grad):
                return fn()

        self._ensure_thread()
        self._requests.put(guarded)
        try:
            status, payload = self._results.get(timeout=deadline_s)
        except queue.Empty:
            self.hung = True
            # pre-queue the shutdown sentinel: if the stuck call ever
            # returns, the abandoned worker exits instead of waiting on
            # the request queue forever
            self._requests.put(None)
            raise WatchdogTimeoutError(phase, deadline_s) from None
        if status == "err":
            raise payload
        return payload

    def close(self, timeout_s: float = 5.0) -> bool:
        """Join the worker thread (call on run completion).  Returns
        True when the thread is gone; a hung worker is abandoned
        immediately (returns False) rather than blocking the caller."""
        th = self._thread
        self._thread = None
        if th is None or not th.is_alive():
            return True
        if self.hung:
            return False
        self._requests.put(None)
        th.join(timeout_s)
        return not th.is_alive()


@dataclass(frozen=True)
class SalvagePolicy:
    """How a batch scheduler responds to a failed packed batch.

    With `enabled` the live rows are bisected: a failing subset splits in
    half, a passing subset's results are kept (replica rows are
    independent, so a surviving row's bytes equal its singleton run's).
    Rows that fail alone are quarantined as PoisonRowError;
    `max_probe_runs` bounds the salvage work per batch, past which the
    unresolved rows fail with the original error.  Disabled, a batch
    failure fails every live row."""

    enabled: bool = True
    max_probe_runs: int = 16


@dataclass(frozen=True)
class DegradePolicy:
    """What to do when the device is lost: with cpu_fallback, the
    supervisor re-places the last anchor on the CPU and continues there
    with its `cpu_chunk_fn` (a chunk function of a network built on the
    CPU: a CUDA network does not step CPU tensors), stamping
    {degraded, degraded_at_chunk, platform: "cpu"} into provenance so a
    CPU number can never pass for a card's.  Off by default."""

    cpu_fallback: bool = False
