"""2D device mesh: replica rows and node columns over a `(p_replica,
p_node)` grid of devices, the port's counterpart of the JAX package's
parallel/mesh2d.py.

The replica axis spreads independent simulations; the node axis splits
one simulation's node state.  The JAX package composes the two in one
GSPMD program over a `jax.sharding.Mesh`; the port runs eagerly, so a
layout is carried out by hand:

- `DeviceMesh` stands in for `jax.sharding.Mesh`: a numpy array of
  `torch.device` and its axis names, with `shape[axis]` and `size`.
  Devices may repeat, so any mesh runs on one card (or on a card and
  the host CPU);
- `MeshLayout.place` turns a state into a `PlacedState`: one SimState
  per mesh cell, on that cell's device.  Every leaf is cut by the JAX
  package's rule (`classify_leaf`, the same `_MESSAGE_STORE_FIELDS`
  exclusion by name): a stacked state's rows are split over the replica
  axis; a node column is split over the node axis, and its block is a
  copy that owns its storage, so each cell really holds 1/P of the
  bytes; every other leaf is copied to each cell of its replica row;
- the engine's `step`, `run_ms` and `run_ms_batched` take a placed state
  and return one (`run_placed`): each cell runs the engine's loop on its
  own thread over its own rows, and the cells meet only in
  parallel.exchange (the loop's whole-batch decisions over every cell;
  the node axis's exchanges within a replica row);
- `PlacedState.gather` brings a placed state back to one SimState.

Bit identity: every run on a placed state is bitwise identical, leaf
for leaf, to the unsharded run of the same batch — the bar the JAX
package holds its mesh to.

Where the JAX package replicates a leaf along a mesh axis that the
layout leaves inactive, the port keeps one copy: a layout's cells are
the devices at index 0 of an inactive axis.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..engine.core import SimState
from ..faults.state import FaultState
from ..telemetry.state import TelemetryState
from . import exchange
from .node_shard import _MESSAGE_STORE_FIELDS

REPLICA_AXIS = "replicas"
NODE_AXIS = "nodes"

# protocols whose hooks run on a node block (engine NODE_AXIS); any other
# protocol placed with an active node axis raises naming this item
NODE_AXIS_ITEM = "ROADMAP Queue A 1 (the node axis for the other protocols)"
FAULTS_NODE_AXIS_ITEM = "ROADMAP Queue A 2 (fault-armed engines on the node axis)"


class DeviceMesh:
    """A grid of devices with named axes (the port's `jax.sharding.Mesh`):
    `devices` is a numpy object array of `torch.device`; `shape` maps
    each axis name to its size, in axis order."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.empty(np.shape(devices), dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = torch.device(np.asarray(devices, dtype=object)[idx])
        if arr.ndim != len(axis_names):
            raise ValueError(f"mesh of {arr.ndim} dims needs {arr.ndim} axis names, "
                             f"got {tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"DeviceMesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def make_mesh2d(
    p_replica: int,
    p_node: int,
    devices: Optional[Sequence] = None,
    replica_axis: str = REPLICA_AXIS,
    node_axis: str = NODE_AXIS,
) -> DeviceMesh:
    """A (p_replica, p_node) mesh over ``devices`` (default: every visible
    CUDA device).  The product must equal the device count — a partial
    mesh would leave devices idle while claiming the full fleet's
    geometry."""
    from .device_groups import visible_devices

    devs = list(devices) if devices is not None else visible_devices()
    if p_replica < 1 or p_node < 1:
        raise ValueError(
            f"mesh axes must be >= 1, got ({p_replica}, {p_node})"
        )
    if p_replica * p_node != len(devs):
        raise ValueError(
            f"mesh ({p_replica}, {p_node}) needs {p_replica * p_node} "
            f"devices, have {len(devs)}"
        )
    grid = np.empty(len(devs), dtype=object)
    grid[:] = [torch.device(d) for d in devs]
    return DeviceMesh(grid.reshape(p_replica, p_node), (replica_axis, node_axis))


def classify_leaf(key: str, shape: tuple, n_nodes: int,
                  stacked: bool = True) -> str:
    """Which sharding class a state leaf belongs to: ``"node-column"``
    (shard on the node axis), ``"replica-row"`` (stacked leaf with no
    node dim — sharded on replicas, replicated along nodes) or
    ``"replicated"`` (single-state leaf with no node dim).  ``key`` is
    the leaf's path as the JAX package's keystr renders it
    (``.proto['in_sig0']``); the message-store / telemetry / fault
    side-car exclusion is BY NAME, because a wheel dim can coincide with
    n_nodes without being node-indexed."""
    if any(f in key for f in _MESSAGE_STORE_FIELDS):
        return "replica-row" if stacked else "replicated"
    off = 1 if stacked else 0
    if len(shape) > off and shape[off] == n_nodes:
        return "node-column"
    return "replica-row" if stacked else "replicated"


def keyed_leaves(state: SimState):
    """(keystr, tensor) of every tensor leaf of a SimState, in field order
    (proto keys sorted), with the JAX package's keystr paths."""
    for f in SimState._fields:
        v = getattr(state, f)
        if isinstance(v, dict):
            for k in sorted(v):
                yield f".{f}[{k!r}]", v[k]
        elif isinstance(v, (TelemetryState, FaultState)):
            for name, a in v._asdict().items():
                yield f".{f}.{name}", a
        elif isinstance(v, torch.Tensor):
            yield f".{f}", v


def map_keyed(fn, *states: SimState) -> SimState:
    """Rebuild SimStates of one structure leaf by leaf: `fn(key, *leaves)`
    with the leaf's keystr path."""
    out = {}
    for f in SimState._fields:
        vals = [getattr(s, f) for s in states]
        v = vals[0]
        if isinstance(v, dict):
            out[f] = {k: fn(f".{f}[{k!r}]", *[x[k] for x in vals]) for k in v}
        elif isinstance(v, (TelemetryState, FaultState)):
            out[f] = type(v)(*[fn(f".{f}.{name}", *xs)
                               for name, xs in zip(v._fields, zip(*vals))])
        elif isinstance(v, torch.Tensor):
            out[f] = fn(f".{f}", *vals)
        else:
            out[f] = v
    return SimState(**out)


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """A constructor-time sharding decision: which mesh, and which of its
    axes carry the replica rows / node columns.  Either axis may be None
    — ``MeshLayout(mesh, replica_axis="replicas", node_axis=None)`` is the
    1D replica layout, ``(None, "nodes")`` the 1D node layout of one
    simulation — so every entry point takes ONE layout argument."""

    mesh: DeviceMesh
    replica_axis: Optional[str] = REPLICA_AXIS
    node_axis: Optional[str] = NODE_AXIS

    def __post_init__(self):
        if self.replica_axis is None and self.node_axis is None:
            raise ValueError("MeshLayout needs at least one active axis")
        for ax in (self.replica_axis, self.node_axis):
            if ax is not None and ax not in self.mesh.axis_names:
                raise ValueError(
                    f"axis {ax!r} not in mesh axes {self.mesh.axis_names}"
                )

    # -- geometry -------------------------------------------------------

    @property
    def p_replica(self) -> int:
        return self.mesh.shape[self.replica_axis] if self.replica_axis is not None else 1

    @property
    def p_node(self) -> int:
        return self.mesh.shape[self.node_axis] if self.node_axis is not None else 1

    @property
    def n_devices(self) -> int:
        return self.mesh.size

    def geometry(self) -> tuple:
        """Restart-stable identity of this layout: active axis names and
        sizes in mesh order, plus total device count — the JAX package's
        tuple, which the run cache keys on, so (2,4) and (4,2) over the
        same 8 devices yield distinct geometries."""
        axes = tuple((name, int(self.mesh.shape[name])) for name in self.mesh.axis_names)
        return ("mesh-layout/v1", axes, self.replica_axis, self.node_axis, int(self.mesh.size))

    def describe(self) -> str:
        parts = []
        if self.replica_axis is not None:
            parts.append(f"{self.replica_axis}={self.p_replica}")
        if self.node_axis is not None:
            parts.append(f"{self.node_axis}={self.p_node}")
        return f"mesh[{','.join(parts)}]"

    def cell_device(self, i: int, j: int) -> torch.device:
        """The device of cell (replica block i, node block j)."""
        idx = []
        for name in self.mesh.axis_names:
            idx.append(i if name == self.replica_axis else j if name == self.node_axis else 0)
        return self.mesh.devices[tuple(idx)]

    # -- placement ------------------------------------------------------

    def spec_for(self, key: str, shape: tuple, n_nodes: int) -> tuple:
        """The partition spec of one leaf, as the tuple of axis names
        JAX's PartitionSpec holds: stacked states (replica axis active)
        split every leaf on the replica axis; node columns pick up the
        node axis on their post-replica dim."""
        stacked = self.replica_axis is not None
        cls = classify_leaf(key, shape, n_nodes, stacked=stacked)
        if stacked:
            if cls == "node-column" and self.node_axis is not None:
                return (self.replica_axis, self.node_axis)
            return (self.replica_axis,)
        if cls == "node-column" and self.node_axis is not None:
            return (self.node_axis,)
        return ()

    def validate(self, net, states) -> None:
        """Divisibility preflight: replica rows must divide p_replica and
        n_nodes must divide p_node (`net` may be None without a node
        axis)."""
        if self.replica_axis is not None:
            rows = int(states.time.shape[0]) if states.time.dim() else 0
            if rows == 0 or rows % self.p_replica != 0:
                raise ValueError(
                    f"replica rows ({rows}) must be a positive multiple "
                    f"of the mesh replica axis ({self.p_replica})"
                )
        if self.node_axis is not None and net.n_nodes % self.p_node != 0:
            raise ValueError(
                f"n_nodes ({net.n_nodes}) must divide evenly over the "
                f"mesh node axis ({self.p_node})"
            )

    def place(self, net, states) -> "PlacedState":
        """Commit a state to this layout.  With an active replica axis it
        is a stacked [R, ...] state; without one, a single simulation's
        state.  A placed state is gathered first and placed anew.  `net`
        (anything with `n_nodes`) classifies the node columns; without a
        node axis it may be None."""
        if isinstance(states, PlacedState):
            states = states.gather()
        self.validate(net, states)
        n = net.n_nodes if net is not None else -1
        stacked = self.replica_axis is not None
        if not stacked:
            states = map_keyed(lambda key, a: a.unsqueeze(0), states)
        rows = int(states.time.shape[0])
        rb, nb = rows // self.p_replica, n // self.p_node

        def cut(i: int, j: int):
            dev = self.cell_device(i, j)

            def leaf(key, a):
                # the class of the leaf as the caller handed it (a single
                # state has no leading axis)
                shape = tuple(a.shape) if stacked else tuple(a.shape[1:])
                spec = self.spec_for(key, shape, n)
                part = a[i * rb:(i + 1) * rb]
                if self.node_axis in spec:
                    part = part[:, j * nb:(j + 1) * nb]
                return exchange.copy_to(part, dev)

            return map_keyed(leaf, states)

        cells = tuple(tuple(cut(i, j) for j in range(self.p_node))
                      for i in range(self.p_replica))
        node_keys = frozenset(
            key for key, a in keyed_leaves(states)
            if self.node_axis in self.spec_for(
                key, tuple(a.shape) if stacked else tuple(a.shape[1:]), n))
        return PlacedState(self, cells, stacked, n, node_keys)


def make_mesh2d_layout(
    p_replica: int, p_node: int, devices: Optional[Sequence] = None
) -> MeshLayout:
    """The common construction: a fresh (p_replica, p_node) mesh wrapped
    in a both-axes-active layout."""
    return MeshLayout(make_mesh2d(p_replica, p_node, devices),
                      replica_axis=REPLICA_AXIS, node_axis=NODE_AXIS)


class PlacedState:
    """A state committed to a MeshLayout: `cells[i][j]` is the SimState of
    replica block i and node block j, on `layout.cell_device(i, j)`.
    Cells always carry a leading replica axis; `stacked` False marks a
    single simulation's state (one row), which `gather` returns without
    it."""

    def __init__(self, layout: MeshLayout, cells, stacked: bool, n_nodes: int,
                 node_keys: frozenset, statics=None):
        self.layout = layout
        self.cells = tuple(tuple(row) for row in cells)
        self.stacked = stacked
        self.n_nodes = n_nodes
        # the keys of the leaves split over the node axis
        self.node_keys = node_keys
        # per cell, the full-length static node columns its row gathered
        # once (latency inputs and `down`); they never change in a run
        self.statics = statics

    @property
    def time(self) -> torch.Tensor:
        """The clock of every replica, on the first cell's device."""
        t = self.gather_leaf(".time")
        return t if self.stacked else t[0]

    def gather_leaf(self, key: str) -> torch.Tensor:
        """One leaf of the unsharded state (with the cells' leading axis)
        on the first cell's device."""
        dev = self.layout.cell_device(0, 0)
        rows = []
        for row in self.cells:
            parts = [dict(keyed_leaves(c))[key] for c in row]
            rows.append(exchange.gather_to(parts, dev, 1) if key in self.node_keys
                        else exchange.gather_to(parts[:1], dev, 0))
        return exchange.gather_to(rows, dev, 0)

    def gather(self, device=None) -> SimState:
        """The unsharded state on `device` (default: the first cell's):
        node blocks concatenated in node order, replica blocks in replica
        order, a replicated leaf taken from its row's first cell."""
        dev = torch.device(device) if device is not None else self.layout.cell_device(0, 0)

        def row_state(row):
            def leaf(key, *parts):
                if key in self.node_keys:
                    return exchange.gather_to(parts, dev, 1)
                return exchange.gather_to(parts[:1], dev, 0)

            return map_keyed(leaf, *row)

        rows = [row_state(row) for row in self.cells]
        out = map_keyed(lambda key, *parts: exchange.gather_to(parts, dev, 0), *rows)
        if not self.stacked:
            out = map_keyed(lambda key, a: a[0], out)
        return out

    def leaf_shards(self):
        """(keystr, global shape, global nbytes, the cells' tensors) of
        every leaf; the global shape is the unsharded state's."""
        keys = [k for k, _ in keyed_leaves(self.cells[0][0])]
        by_cell = [[dict(keyed_leaves(c)) for c in row] for row in self.cells]
        for key in keys:
            parts = [[cell[key] for cell in row] for row in by_cell]
            first = parts[0][0]
            shape = list(first.shape)
            shape[0] = sum(row[0].shape[0] for row in parts)
            if key in self.node_keys:
                shape[1] = sum(p.shape[1] for p in parts[0])
            if not self.stacked:
                shape = shape[1:]
            nbytes = int(np.prod(shape, dtype=np.int64)) * first.element_size()
            yield key, tuple(shape), nbytes, [p for row in parts for p in row]


def _own_bytes(t: torch.Tensor) -> torch.Tensor:
    """`t` in a storage of exactly its bytes.  The engine's functional
    scatters return views into buffers a few trash cells longer; a
    placed state keeps every leaf in a storage of its own size, so that
    what a cell holds is its share and nothing more."""
    if t.untyped_storage().nbytes() == t.numel() * t.element_size() and t.is_contiguous():
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _storage_bytes(t: torch.Tensor) -> int:
    """The bytes a tensor's storage really holds on its device."""
    return int(t.untyped_storage().nbytes())


# ---------------------------------------------------------------------------
# ownership audit: the 1/P invariant on a 2D mesh


def channel_ownership(net, states) -> dict:
    """{leaf_path: (per_device_bytes, total_bytes)} for every
    aggregation-channel array (``in_sig*``) of a placed state, measured
    from the cells' own storage — what each device really holds, not what
    the layout promised.  An unplaced state holds each array whole on its
    one device."""
    if not isinstance(states, PlacedState):
        return {key: (_storage_bytes(a), a.numel() * a.element_size())
                for key, a in keyed_leaves(states) if "in_sig" in key}
    out = {}
    for key, _shape, nbytes, shards in states.leaf_shards():
        if "in_sig" in key:
            out[key] = (max(_storage_bytes(s) for s in shards), nbytes)
    return out


def assert_channel_ownership(net, states, n_devices: Optional[int] = None):
    """Every channel array's per-device shard is exactly total_bytes /
    n_devices (default: the layout's device count; for an unplaced
    state, every visible CUDA device).  Raises AssertionError naming the
    first offending leaf."""
    if n_devices is None:
        n_devices = (states.layout.n_devices if isinstance(states, PlacedState)
                     else max(1, torch.cuda.device_count()))
    owned = channel_ownership(net, states)
    if not owned:
        raise AssertionError(
            "no in_sig channel arrays found — ownership unverifiable"
        )
    for key, (per_dev, total) in owned.items():
        expect = total // n_devices
        if per_dev != expect:
            raise AssertionError(
                f"channel ownership violated for {key}: per-device "
                f"{per_dev} B != total {total} B / {n_devices} devices "
                f"({expect} B)"
            )
    return owned


# ---------------------------------------------------------------------------
# running a placed state: one engine loop per cell


class Cell:
    """What a cell's engine copy knows of the mesh: its node block
    [lo, hi), its replica row's group (`nodes`, None without a node axis)
    and every cell's (`world`), with its rank in each, and the row's
    full-length static node columns (`static`: the latency inputs,
    `down`: bool[R, N]) on its device."""

    def __init__(self, i: int, j: int, device, lo: int, hi: int, nodes, world, world_rank):
        self.i, self.j = i, j
        self.device = torch.device(device)
        self.lo, self.hi = lo, hi
        self.nodes = nodes
        self.node_rank = j
        self.world = world
        self.world_rank = world_rank
        self.static = None
        self.down = None
        self._ids = None

    def node_ids(self) -> torch.Tensor:
        """The block's global node ids, int32, on the cell's device."""
        if self._ids is None:
            self._ids = torch.arange(self.lo, self.hi, dtype=torch.int32, device=self.device)
        return self._ids


def _check_node_axis(net) -> None:
    if not getattr(net.protocol, "NODE_AXIS", False):
        raise NotImplementedError(
            f"{type(net.protocol).__name__} has no node-block hooks: placing it "
            f"with an active node axis waits for {NODE_AXIS_ITEM}"
        )
    if net.faults is not None:
        raise NotImplementedError(
            f"a fault-armed engine on an active node axis waits for {FAULTS_NODE_AXIS_ITEM}"
        )


def _row_statics(cell: Cell, state: SimState):
    """The row's full-length latency inputs and `down` on this cell's
    device, gathered over the row's node blocks."""
    from ..core.latency import LatencyStatic

    cols = [state.x, state.y, state.extra_latency, state.city_idx, state.down]
    if cell.nodes is not None:
        cols = exchange.all_gather(cell.nodes, cell.node_rank, cols, dim=1)
    return LatencyStatic(*cols[:4]), cols[4]


def run_placed(net, placed: PlacedState, method: str, *args, **kwargs) -> PlacedState:
    """`net.<method>(placed, ...)` for `step`, `run_ms` and
    `run_ms_batched`: every cell runs the engine method on its own rows
    on a thread of its own, its engine a copy that knows its cell; the
    result is the placed state of the cells' results.  Afterwards an
    event-driven run's `net.jump_stats` is the whole batch's."""
    lay = placed.layout
    p_r, p_n = lay.p_replica, lay.p_node
    if p_n > 1:
        _check_node_axis(net)
    n = net.n_nodes
    nb = n // p_n
    world = exchange.Group([lay.cell_device(i, j) for i in range(p_r) for j in range(p_n)])
    rows = [exchange.Group([lay.cell_device(i, j) for j in range(p_n)]) if p_n > 1 else None
            for i in range(p_r)]
    nets, tasks = [], []
    for i in range(p_r):
        for j in range(p_n):
            cell = Cell(i, j, lay.cell_device(i, j), j * nb, (j + 1) * nb, rows[i], world,
                        i * p_n + j)
            cnet = cell_engine(net, cell)
            nets.append(cnet)
            state = placed.cells[i][j]
            prev = placed.statics[i][j] if placed.statics is not None else None

            def task(cnet=cnet, cell=cell, state=state, prev=prev):
                cell.static, cell.down = prev if prev is not None else _row_statics(cell, state)
                return getattr(cnet, method)(state, *args, **kwargs), (cell.static, cell.down)

            tasks.append(task)
    outs = exchange.spmd(tasks, [world] + [g for g in rows if g is not None])
    cells = [[map_keyed(lambda key, a: _own_bytes(a), outs[i * p_n + j][0])
              for j in range(p_n)] for i in range(p_r)]
    statics = [[outs[i * p_n + j][1] for j in range(p_n)] for i in range(p_r)]
    stats = [nets[i * p_n].jump_stats for i in range(p_r)]
    if stats[0] is not None:
        dev = lay.cell_device(0, 0)
        net.jump_stats = {
            "iterations": stats[0]["iterations"],
            "last_tick": exchange.gather_to([s["last_tick"] for s in stats], dev),
            "ticks": exchange.gather_to([s["ticks"] for s in stats], dev),
        }
    return PlacedState(lay, cells, placed.stacked, placed.n_nodes, placed.node_keys, statics)


def cell_engine(net, cell: Cell):
    """A copy of `net` bound to `cell`: its device, the message-size table
    there and the cell context the node-block hooks read."""
    out = copy.copy(net)
    out.cell = cell
    out.device = cell.device
    out._msg_sizes = torch.as_tensor(net._msg_sizes_host, device=cell.device)
    out.jump_stats = None
    return out
