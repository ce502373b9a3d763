"""Multi-device parallelism of the port, over the JAX package's two axes:

  * replica axis — independent simulations split over a device mesh
    (replica_shard: `shard_replicas`, the run cache with its `layout=`
    and statistics reduced across shards; device_groups: the serving
    scheduler's lanes);
  * node axis — one simulation's node state split over the mesh
    (node_shard: `shard_state_by_node`, `run_ms_node_sharded`, the
    `pingpong_progression` spike, `enable_node_sharding` for the channel
    exchange's capacity).

mesh2d composes the two on a (replicas, nodes) mesh of devices that may
repeat; a run on a placed state is one engine loop per mesh cell, and
the cells meet only in exchange (all_to_all, all_gather, all_reduce).
"""

from .device_groups import DeviceGroup, make_device_groups
from .mesh2d import (
    DeviceMesh,
    MeshLayout,
    PlacedState,
    assert_channel_ownership,
    channel_ownership,
    classify_leaf,
    make_mesh2d,
    make_mesh2d_layout,
)
from .node_shard import (
    enable_node_sharding,
    node_shard_bytes,
    pingpong_progression,
    run_ms_node_sharded,
    shard_state_by_node,
)
from .replica_shard import (
    clear_run_cache,
    run_cache_info,
    run_cache_metrics,
    shard_replicas,
    sharded_run_stats,
)

__all__ = [
    "DeviceGroup",
    "DeviceMesh",
    "MeshLayout",
    "PlacedState",
    "assert_channel_ownership",
    "channel_ownership",
    "classify_leaf",
    "make_device_groups",
    "make_mesh2d",
    "make_mesh2d_layout",
    "clear_run_cache",
    "enable_node_sharding",
    "node_shard_bytes",
    "pingpong_progression",
    "run_cache_info",
    "run_cache_metrics",
    "run_ms_node_sharded",
    "shard_state_by_node",
    "shard_replicas",
    "sharded_run_stats",
]
