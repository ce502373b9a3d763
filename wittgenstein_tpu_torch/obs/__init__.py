"""The port's observability spine: the trace context, the flight
recorder, per-tenant attribution, the metric history and the invariant
sentinel.

One TraceContext (run_id / job_id / tenant_id / chunk_seq) is minted per
unit of work and threaded through the records; one FlightRecorder ring
holds the structured events of a run; `batch_attribution` slices a
packed batch's counters by replica row; a `TimeSeriesStore` keeps the
history the Supervisor feeds at each chunk boundary, and an
`InvariantSentinel` checks the store invariant, drops and headroom
against the capacity table there.  Host-side only: simulation state is
the same with all of it armed.  The JAX package's SLO burn-rate engine
belongs with the serving fleet and is not ported yet.
"""

from .attribution import batch_attribution, replica_rows
from .context import TraceContext, mint_context, new_run_id
from .monitor import InvariantSentinel, load_capacity_table
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
from .timeseries import TimeSeriesStore

__all__ = [
    "TraceContext",
    "mint_context",
    "new_run_id",
    "FlightRecorder",
    "get_recorder",
    "reset_default_recorder",
    "read_events",
    "failure_dump_paths",
    "batch_attribution",
    "replica_rows",
    "TimeSeriesStore",
    "InvariantSentinel",
    "load_capacity_table",
    "KNOWN_KINDS",
    "LIVE_BASENAME",
    "DUMP_BASENAME",
    "ENV_DIR",
]
