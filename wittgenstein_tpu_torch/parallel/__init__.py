"""Replica-axis parallelism of the port: the run cache (one program per
network, horizon and input geometry, with the run statistics reduced on
the device) and the device groups the serving scheduler's lanes run on.

Splitting one batch or one simulation's nodes across devices (the JAX
package's mesh2d and node_shard) waits for the multi-device slice
(ROADMAP Queue A 16).
"""

from .device_groups import DeviceGroup, make_device_groups
from .replica_shard import (
    clear_run_cache,
    run_cache_info,
    run_cache_metrics,
    shard_replicas,
    sharded_run_stats,
)

__all__ = [
    "DeviceGroup",
    "make_device_groups",
    "clear_run_cache",
    "run_cache_info",
    "run_cache_metrics",
    "shard_replicas",
    "sharded_run_stats",
]
