"""Batched protocol contract.

The batched analog of core Protocol.java + Message.action: a protocol is a
set of vectorized hooks over the struct-of-arrays state.  Every state
tensor carries the replica axis R in front, and every hook that runs
inside a tick receives the tick `t` it executes as a host int — what the
JAX package's hooks read from `state.time`.  Per-ms protocols run in
lockstep, so `t` is every replica's clock; on the event-driven loop it is
the clock of the replicas that take the step (the others' results are
discarded).  Hooks therefore read `t`, never `state.time`.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import torch

from .density import narrow_tree, widen_tree

# Machine-readable contract metadata, the JAX package's, read by the
# contract checks (wittgenstein_tpu_torch.analysis).

# SimState fields owned by the engine: protocol hooks never write them
# (`deliver` returns emissions instead of touching the store; the engine
# ticks the counters and the clock).  A protocol with a genuine exception
# declares it in DELIVER_MAY_TOUCH.
ENGINE_OWNED_FIELDS = (
    "time",
    "seed",
    "send_ctr",
    "msg_valid",
    "msg_arrival",
    "msg_from",
    "msg_to",
    "msg_type",
    "msg_payload",
    "whl_fill",
    "ovf_valid",
    "ovf_arrival",
    "ovf_from",
    "ovf_to",
    "ovf_type",
    "ovf_payload",
    "msg_head",
    "dropped",
    "tele",
    "faults",
)

# hooks that run inside a tick vs host-side construction hooks
KERNEL_HOOKS = ("deliver", "tick", "tick_beat", "tick_post", "all_done")
HOST_HOOKS = ("proto_init", "initial_emissions", "msg_size", "n_msg_types", "mtype")


class BatchedProtocol:
    """Subclass and override.  MSG_TYPES maps message-type names to the int
    codes stored in the ring."""

    MSG_TYPES: List[str] = []
    PAYLOAD_WIDTH: int = 0
    # None = tick() does nothing time-sensitive, so the engine may skip
    # empty milliseconds (jump to the next arrival); 1 = per-ms work.  The
    # port runs these two.
    TICK_INTERVAL: int | None = 1
    # Time coarsening for event-driven protocols (TICK_INTERVAL None):
    # arrivals are delivered together at the next multiple of this grid,
    # delaying each by < TIME_QUANTUM ms.  1 = exact arrival times.
    TIME_QUANTUM: int = 1
    # Beat structure: periodic work that fires only when t % BEAT_PERIOD is
    # in BEAT_RESIDUES goes in tick_beat(), which the lockstep loop runs
    # only on beat ticks.  tick() must not include the beat work.
    BEAT_PERIOD: int | None = None
    BEAT_RESIDUES: tuple | None = None
    # latency_arrivals calls tick_beat makes; on off-beat ticks the engine
    # advances send_ctr by this amount so the per-event RNG stream is the
    # same as on the ungated path
    BEAT_SEND_CALLS: int = 0
    # engine-owned SimState fields this protocol's deliver() may write
    # (empty for every protocol; an exception is declared here so the
    # ownership check stays exact)
    DELIVER_MAY_TOUCH: tuple = ()
    # contract rule ids (e.g. "SL404") suppressed for this protocol's
    # dynamic checks; use sparingly, with a comment
    SIMLINT_SUPPRESS: tuple = ()
    # names of state.proto leaves that are derived caches, recomputable
    # from the authoritative leaves at any tick boundary; a protocol
    # declaring leaves here overrides recompute_caches(), which SL701
    # holds the carried leaves to bitwise after concrete steps
    DERIVED_CACHE_LEAVES: tuple = ()
    # narrow-storage declarations (engine.density.NarrowLeaf)
    NARROW_LEAVES: tuple = ()
    # proto leaves the JAX package carries as uint32 words (int32 bit views
    # here; a name ending in "*" is a prefix), and, for a protocol with
    # words, the proto keys that identify its state — interop.state_to_numpy
    # reads both
    WORD_LEAVES: tuple = ()
    PROTO_KEYS: tuple = ()

    def contract(self) -> dict:
        """Machine-readable contract summary (instance-level: factories may
        set BEAT_* per instance), the JAX package's keys and values.  The
        port's WORD_LEAVES and PROTO_KEYS describe interop, not the
        contract, and stay out of it."""
        msg_types = self.MSG_TYPES
        return {
            "protocol": type(self).__name__,
            "msg_types": list(msg_types) if msg_types else [],
            "n_msg_types": self.n_msg_types(),
            "payload_width": int(self.PAYLOAD_WIDTH),
            "tick_interval": self.TICK_INTERVAL,
            "time_quantum": int(self.TIME_QUANTUM),
            "beat_period": self.BEAT_PERIOD,
            "beat_residues": tuple(self.BEAT_RESIDUES) if self.BEAT_RESIDUES else None,
            "beat_send_calls": int(self.BEAT_SEND_CALLS),
            "engine_owned_fields": list(ENGINE_OWNED_FIELDS),
            "deliver_may_touch": list(self.DELIVER_MAY_TOUCH),
            "simlint_suppress": list(self.SIMLINT_SUPPRESS),
            "derived_cache_leaves": list(self.DERIVED_CACHE_LEAVES),
            "narrow_leaves": [s.key() for s in self.NARROW_LEAVES],
        }

    def n_msg_types(self) -> int:
        return max(1, len(self.MSG_TYPES))

    def mtype(self, name: str) -> int:
        return self.MSG_TYPES.index(name)

    def msg_size(self, mtype: int) -> int:
        """Bytes per message type (Message.size, Message.java:28 default 1)."""
        return 1

    # -- hooks ---------------------------------------------------------------
    def proto_init(self, n_nodes: int, device=None) -> Any:
        """Protocol-state dict for a fresh replica (Protocol.init)."""
        return {}

    def initial_emissions(self, net, state) -> List:
        """Messages injected at t=0 (the protocol's init() sends)."""
        return []

    def deliver(self, net, state, deliver_mask, t: int) -> Tuple[Any, List]:
        """Handle all due messages.  Returns (new state, emissions); must
        not touch msg_* (the engine owns the store).  `deliver_mask` is
        bool[R, D] over the delivery view."""
        return state, []

    def tick(self, net, state, t: int):
        """Per-millisecond hook after delivery."""
        return state

    def tick_beat(self, net, state, t: int):
        """Beat-gated periodic work; a no-op on off-beat ticks (its own
        masks), since the generic path calls it every tick."""
        return state

    def tick_post(self, net, state, t: int):
        """Per-tick work that must run after tick_beat."""
        return state

    def widen_proto(self, proto):
        """NARROW_LEAVES -> int32 compute view of a proto dict."""
        return widen_tree(proto, self.NARROW_LEAVES)

    def narrow_proto(self, proto):
        """int32 compute view -> declared storage dtypes."""
        return narrow_tree(proto, self.NARROW_LEAVES)

    def recompute_caches(self, state) -> dict:
        """From-scratch values for every DERIVED_CACHE_LEAVES leaf, as a
        {leaf_name: tensor} dict computed from the authoritative proto
        leaves only: the consistency oracle of SL701."""
        return {}

    # -- termination ----------------------------------------------------------
    def all_done(self, state) -> torch.Tensor:
        """bool[R]: which replicas finished."""
        return torch.zeros(state.down.shape[0], dtype=torch.bool,
                           device=state.down.device)
