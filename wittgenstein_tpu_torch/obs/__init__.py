"""The port's observability spine: the trace context and the flight recorder.

One TraceContext (run_id / job_id / tenant_id / chunk_seq) is minted per
unit of work and threaded through the records; one FlightRecorder ring
holds the structured events of a run.  Host-side only: simulation state
is the same with both armed.  The JAX package's attribution, SLO,
time-series and invariant-monitor modules are not ported yet.
"""

from .context import TraceContext, mint_context, new_run_id
from .recorder import (
    DUMP_BASENAME,
    ENV_DIR,
    KNOWN_KINDS,
    LIVE_BASENAME,
    FlightRecorder,
    failure_dump_paths,
    get_recorder,
    read_events,
    reset_default_recorder,
)

__all__ = [
    "TraceContext",
    "mint_context",
    "new_run_id",
    "FlightRecorder",
    "get_recorder",
    "reset_default_recorder",
    "read_events",
    "failure_dump_paths",
    "KNOWN_KINDS",
    "LIVE_BASENAME",
    "DUMP_BASENAME",
    "ENV_DIR",
]
