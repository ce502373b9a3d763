"""Node-axis sharding: one simulation's node state split across devices,
the port's counterpart of the JAX package's parallel/node_shard.py.

The replica axis (replica_shard) scales the number of simulations; this
axis scales ONE simulation past a single device's memory.  Two layers,
as in the JAX package:

1. **The real engine on node blocks** (`shard_state_by_node` +
   `run_ms_node_sharded`, and the node axis of any mesh2d layout): each
   node block runs the tick on its own rows, and every effect that
   crosses blocks goes through parallel.exchange.  The JAX package lets
   XLA's partitioner place those collectives; the eager port writes
   them out, at these points:
   - *hooks on a block*: a hook's node ids are its block's global ids
     (`net.node_ids`); XOR peer arithmetic and every RNG hash keep
     global ids, node columns are indexed by local position
     (`net.to_local`), as in the spike below ("gathers use local
     positions, RNG uses global ids");
   - *static tables*: the latency inputs and `down` of every node are
     gathered once per run onto each cell (they never change in a run);
     the protocols' own tables (`_tab`, P2PFlood's adjacency) are
     uploaded once per device;
   - *the message store and `send_ctr` are replicated along nodes*
     (`_MESSAGE_STORE_FIELDS`): a protocol's store emissions are the
     row's, merged with one `all_reduce` any of the blocks' masks
     (`net.row_any`), so every block draws the same counters over the
     unsharded run's rows in its order and applies the same insert;
     delivery hands each block its own receivers;
   - *the aggregation channel*: a send's update rows are bucketed by
     destination block and exchanged with one `all_to_all`
     (`_channel_commit_sharded`); the receiver counters that the send
     path ticks at send time travel as an `all_to_all` of per-block
     counts;
   - *per-replica values summed or tested over nodes* are all-reduced:
     `all_done` (all), `displaced` and the telemetry counters fed by a
     block's own sends (sum), the telemetry ring's per-node totals
     (sum).  The store's occupancy answers need none: the store is the
     row's on every block;
   - *the loop's decisions* (clock groups, the beat, stop_when_done, the
     consensus-jump tick) are reduced over every cell, so every replica
     of every block takes the unsharded run's steps.

   Handel (with or without telemetry), PingPong and P2PFlood run on node
   blocks (`NODE_AXIS`); any other protocol, and a fault-armed engine,
   raises when placed with an active node axis.

2. **The spike** (`pingpong_progression`): the PingPong broadcast/reply
   pattern with explicit collectives — each block computes its arrivals
   with the real latency models and counter RNG, and the witness's
   progression is an `all_reduce` sum.
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch

from ..core.latency import LatencyStatic, vec_latency
from ..core.node import Node, build_node_columns
from ..core.registries import registry_network_latencies, registry_node_builders
from ..engine.rng import hash32, pseudo_delta
from ..utils.javarand import JavaRandom
from . import exchange

# engine-owned message-store fields of SimState: the time wheel [W, B],
# its fill summary [W] and the overflow lane [V] are indexed by arrival
# tick, not by node — replicated even when a wheel dimension coincides
# with n_nodes.  (msg_received/msg_sent are NODE columns and absent.)
_MESSAGE_STORE_FIELDS = (
    ".msg_valid", ".msg_arrival", ".msg_from", ".msg_to", ".msg_type",
    ".msg_payload", ".whl_fill", ".ovf_valid", ".ovf_arrival", ".ovf_from",
    ".ovf_to", ".ovf_type", ".ovf_payload",
    # telemetry side-car: counter rows are mtype-/window-indexed, never
    # node-indexed
    ".tele",
    # fault side-car: replicated as a whole schedule
    ".faults",
)


def enable_node_sharding(net, mesh, axis: str = "nodes",
                         exchange_capacity: Optional[int] = None):
    """A COPY of the engine that names the node mesh and bounds the
    channel exchange.  `exchange_capacity` bounds each destination
    block's bucket of a send's update rows (None: the exact capacity,
    every row; a bound counts the rows past it in proto["displaced"]).

    The JAX package's engine without this call partitions the channel
    commit with XLA's partitioner; the port has no such alternative, so
    every node-sharded run commits through the exchange, at the exact
    capacity unless this call bounds it.  The copy's cache keys gain the
    node axis (and `cache_key` the mesh's identity), as the JAX
    package's do."""
    net = copy.copy(net)
    net.node_mesh = mesh
    net.node_axis = axis
    net.exchange_capacity = exchange_capacity
    return net


def node_shard_bytes(state, n: int) -> dict:
    """{array_name: per_device_bytes} for every node-axis array of a
    placed state, measured from the cells' own storage (what each device
    really holds).  The arrays are those whose unsharded leading dim is
    `n` (a single simulation's node columns)."""
    from .mesh2d import PlacedState

    if not isinstance(state, PlacedState):
        return {}
    out = {}
    for key, shape, _nbytes, shards in state.leaf_shards():
        if shape and shape[0] == n:
            out[key] = max(int(s.untyped_storage().nbytes()) for s in shards)
    return out


def shard_state_by_node(net, state, mesh, axis: str = "nodes"):
    """Place ONE simulation's state onto the mesh with every [N, ...]
    array split over `axis` and everything else (scalars, the message
    store, side-cars) copied to every block: a mesh2d.MeshLayout with
    only the node axis active, so both entry points share one rule."""
    from .mesh2d import MeshLayout

    return MeshLayout(mesh, replica_axis=None, node_axis=axis).place(net, state)


def run_ms_node_sharded(net, state, ms: int, layout=None):
    """Advance a node-sharded simulation `ms` milliseconds: the engine's
    own `run_ms` on the placed state.  Call with the output of
    shard_state_by_node, or pass a mesh2d.MeshLayout to place `state`
    here."""
    if layout is not None:
        state = layout.place(net, state)
    return net.run_ms(state, ms)


def _build_population(node_ct: int, node_builder_name, network_latency_name):
    nb = registry_node_builders.get_by_name(node_builder_name)
    latency = registry_network_latencies.get_by_name(network_latency_name)
    rd = JavaRandom(0)
    nodes = [Node(rd, nb) for _ in range(node_ct)]
    cols = build_node_columns(nodes, getattr(latency, "city_index", None))
    return latency, cols


def pingpong_progression(
    node_ct: int,
    query_times,
    mesh=None,
    axis: str = "nodes",
    node_builder_name: Optional[str] = None,
    network_latency_name: Optional[str] = None,
    seed: int = 0,
    device=None,
):
    """Witness pong counts at `query_times`, int32.  With a mesh, node
    columns are split over `axis`, each block counts its own arrivals on
    its device, and the counts are an `all_reduce` sum: equal to the
    unsharded path.  Without one the counts run on `device` (CUDA unless
    the CPU is asked for)."""
    from ..engine.core import resolve_device

    latency, cols = _build_population(node_ct, node_builder_name, network_latency_name)
    x = np.asarray(cols["x"], np.int32)
    y = np.asarray(cols["y"], np.int32)
    el = np.asarray(cols["extra_latency"], np.int32)
    ci = np.asarray(cols.get("city_idx", np.full(node_ct, -1)), np.int32)
    qts_host = np.asarray(query_times, np.int32)

    def counts(lo: int, hi: int, dev) -> torch.Tensor:
        """Pong-at-witness arrival counts for nodes [lo, hi) with the
        engine's send semantics: Ping multicast at t=1 with one shared
        seed + per-GLOBAL-destination pseudo delta, Pong replies one ms
        after delivery.  Static row 0 is the witness; gathers use local
        positions, RNG uses global ids."""
        def col(a):
            # the engine's latency models take [R, N] columns: one row
            return torch.as_tensor(np.concatenate([a[:1], a[lo:hi]])[None], device=dev)

        static = LatencyStatic(col(x), col(y), col(el), col(ci))
        ids = torch.arange(lo, hi, dtype=torch.int32, device=dev)[None]
        lpos = torch.arange(1, hi - lo + 1, dtype=torch.int32, device=dev)[None]
        zero = torch.zeros_like(lpos)
        ping_seed = hash32(seed, 1, 0xA0)
        d1 = pseudo_delta(ids, ping_seed)
        arr1 = 1 + vec_latency(latency, static, zero, lpos, d1)
        pong_seed = hash32(seed, arr1 + 1, ids, 0xB0)
        d2 = pseudo_delta(zero, pong_seed)
        arr = arr1 + 1 + vec_latency(latency, static, lpos, zero, d2)
        qts = torch.as_tensor(qts_host, device=dev)
        return (arr[0][None, :] <= qts[:, None]).to(torch.int32).sum(1, dtype=torch.int32)

    if mesh is None:
        return counts(0, node_ct, resolve_device(device))
    names = list(mesh.axis_names)
    p = mesh.shape[axis]
    if node_ct % p:
        raise ValueError(f"node_ct {node_ct} not divisible by mesh axis {axis!r} ({p})")
    blk = node_ct // p
    devs = [mesh.devices[tuple(j if nm == axis else 0 for nm in names)] for j in range(p)]
    group = exchange.Group(devs)

    def task(j: int):
        return exchange.all_reduce(group, j, counts(j * blk, (j + 1) * blk, devs[j]), "sum")

    return exchange.spmd([lambda j=j: task(j) for j in range(p)], [group])[0]
