"""Flight recorder: a bounded host-side ring of structured run events.

Producers (the search driver, and later the supervisor and the serving
layer) record small dict events, each stamped with a wall-clock `ts`, a
monotone `seq` and the TraceContext ids, so the question "what happened
to this run, in order?" has an answer.  Both modes are host-side only;
simulation state is the same with the recorder armed.

- **ring only** (default): a `deque(maxlen=capacity)` of the last N
  events; `dump(path)` writes them atomically (pid-suffixed temp file and
  `os.replace`, as `engine/checkpoint.py` writes).
- **armed path**: constructed with `path=`, every event is also appended
  and flushed to that JSONL file when it is recorded, so the tail
  survives a killed process.

The process-default recorder (`get_recorder`) writes a file only when
`WITT_OBS_DIR` names a directory; otherwise it keeps its ring in memory.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import time
from typing import List, Optional

from ..runtime.locks import make_lock
from .context import TraceContext

# the armed live file and the atomic failure dump
LIVE_BASENAME = "flight_recorder.jsonl"
DUMP_BASENAME = "flight_recorder_dump.jsonl"

# when set, the process-default recorder persists there, and failure
# dumps land there too
ENV_DIR = "WITT_OBS_DIR"

DEFAULT_CAPACITY = 4096

# The event vocabulary, the JAX package's catalog as it stands (record()
# does not enforce membership).  The port's producers so far are the
# search driver (search-generation, search-resume, search-complete,
# search-pinned, checkpoint) and the lock tracer (lock-order-violation).
KNOWN_KINDS = (
    "admission",
    "admission-rejected",
    "pack",
    "batch-failed",
    "chunk",
    "retry",
    "watchdog",
    "degrade",
    "checkpoint",
    "resume",
    "kill",
    "run-start",
    "run-end",
    "lane-failed",
    "lane-restart",
    "lane-abandoned",
    "family-rebound",
    "binding-expired",
    "salvage-start",
    "salvage-run",
    "quarantine",
    "salvage-done",
    "drain-start",
    "drain-end",
    "slo-alert",
    "slo-resolved",
    "invariant-violation",
    "lock-order-violation",
    # adversary search campaigns (search/driver.py)
    "search-generation",
    "search-resume",
    "search-complete",
    "search-pinned",
)


class FlightRecorder:
    """Thread-safe bounded event ring with optional tail-safe JSONL."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY, path: Optional[str] = None):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self.path = path
        self._ring: collections.deque = collections.deque(maxlen=self.capacity)
        self._seq = itertools.count()
        self._lock = make_lock("obs.recorder")
        if path:
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)

    def record(self, kind: str, ctx: Optional[TraceContext] = None, **fields) -> dict:
        """Append one event.  ``ctx`` ids land as top-level fields so a
        grep for a run_id finds every event of the run.  Returns the
        event dict (callers may log or assert on it)."""
        ev = {"ts": round(time.time(), 6), "kind": str(kind)}
        if ctx is not None:
            ev.update(ctx.ids())
        for key, val in fields.items():
            # reserved envelope keys cannot be clobbered by payloads
            if val is not None and key not in ("ts", "kind", "seq"):
                ev[key] = val
        with self._lock:
            ev["seq"] = next(self._seq)
            self._ring.append(ev)
            if self.path:
                # append+flush per event: the tail survives SIGKILL.
                with open(self.path, "a", encoding="utf-8") as fh:
                    fh.write(json.dumps(ev, sort_keys=True) + "\n")
                    fh.flush()
                    os.fsync(fh.fileno())
        return ev

    def events(self, run_id: Optional[str] = None) -> List[dict]:
        """Snapshot of the ring (oldest first), optionally one run only."""
        with self._lock:
            evs = list(self._ring)
        if run_id is not None:
            evs = [e for e in evs if e.get("run_id") == run_id]
        return evs

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def dump(self, path: str) -> str:
        """Write the ring to ``path`` as JSONL, atomically (pid-tmp +
        os.replace) so a dump raced by a crash is intact-or-absent.
        Returns the path."""
        evs = self.events()
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as fh:
            for ev in evs:
                fh.write(json.dumps(ev, sort_keys=True) + "\n")
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        return path


def read_events(paths) -> List[dict]:
    """Load flight-recorder JSONL file(s), skipping torn tail lines
    (the armed file may end mid-write after SIGKILL — same tolerance as
    telemetry.read_run_records).  Events are merged and ordered by
    (ts, seq) so multi-process runs (victim + resume) interleave
    correctly."""
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    out: List[dict] = []
    for path in paths:
        try:
            with open(path, "r", encoding="utf-8") as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        ev = json.loads(line)
                    except json.JSONDecodeError:
                        continue  # torn tail line
                    if isinstance(ev, dict):
                        out.append(ev)
        except OSError:
            continue
    out.sort(key=lambda e: (e.get("ts", 0.0), e.get("seq", 0)))
    return out


# The process-default recorder: components not handed an explicit one
# share this ring, armed (JSONL under the directory) when WITT_OBS_DIR
# is set.

_default_recorder: Optional[FlightRecorder] = None
_default_lock = make_lock("obs.recorder_default")


def get_recorder() -> FlightRecorder:
    """The lazily-created process-default recorder (see module note)."""
    global _default_recorder
    with _default_lock:
        if _default_recorder is None:
            obs_dir = os.environ.get(ENV_DIR)
            path = os.path.join(obs_dir, LIVE_BASENAME) if obs_dir else None
            _default_recorder = FlightRecorder(path=path)
        return _default_recorder


def reset_default_recorder() -> None:
    """Drop the process-default recorder (tests; env-var changes)."""
    global _default_recorder
    with _default_lock:
        _default_recorder = None


def failure_dump_paths(checkpoint_dir: Optional[str] = None) -> List[str]:
    """Where a failure dump should land: beside the checkpoints (where a
    resume looks) and under WITT_OBS_DIR.  Either or both may be absent."""
    paths = []
    if checkpoint_dir:
        paths.append(os.path.join(checkpoint_dir, DUMP_BASENAME))
    obs_dir = os.environ.get(ENV_DIR)
    if obs_dir:
        paths.append(os.path.join(obs_dir, DUMP_BASENAME))
    return paths
