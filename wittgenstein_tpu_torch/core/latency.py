"""The default network latency model, vectorized over the replica axis.

Reference semantics: core NetworkLatency.java.  The port keeps only what
the default model needs: `NetworkLatencyByDistanceWJitter` with its
exact host table, the shared `vec_latency` wrapper
(NetworkLatency.getLatency, NetworkLatency.java:27-34) and the toroidal
distance with its integer-sqrt snap.  All randomness is externalized into
`delta` in [0, 99], which the engine draws from its counter RNG.

Every column is [R, N] and every index array [R, ...]: the replica axis
is explicit (see ops/indexing.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.indexing import take
from ..utils.gpd import GeneralizedParetoDistribution
from .geo import MAX_DIST, MAX_X, MAX_Y

_WAN_GPD = GeneralizedParetoDistribution(1.4, -0.3, 0.35)
# delta only ever takes 100 values: precompute the jitter table once.
JITTER_TABLE = np.array([_WAN_GPD.inverse_f(d / 100.0) for d in range(100)])


class NetworkLatency:
    def ext_vec(self, static: "LatencyStatic", from_idx, to_idx, delta):
        """Latencies for index arrays, before the shared extra-latency
        and clamp terms of `vec_latency`; override per model."""
        raise NotImplementedError

    def __str__(self) -> str:
        return type(self).__name__


class LatencyStatic:
    """Static per-node columns the vectorized models read: positions,
    extra latency and city indices, each [R, N] int32."""

    def __init__(self, x, y, extra_latency, city_idx=None):
        self.x = x
        self.y = y
        self.extra_latency = extra_latency
        self.city_idx = city_idx


def vec_latency(model: NetworkLatency, static: LatencyStatic, from_idx, to_idx, delta):
    """Shared wrapper (getLatency semantics) around a model's ext_vec."""
    ext = model.ext_vec(static, from_idx, to_idx, delta)
    extras = take(static.extra_latency, from_idx) + take(static.extra_latency, to_idx)
    lat = torch.clamp(extras + ext, min=1)
    return torch.where(from_idx == to_idx, 1, lat).to(torch.int32)


def _dist_vec(static: LatencyStatic, from_idx, to_idx):
    """Toroidal distance, int-truncated like Node.dist."""
    dx = torch.abs(take(static.x, from_idx) - take(static.x, to_idx))
    dx = torch.minimum(dx, MAX_X - dx)
    dy = torch.abs(take(static.y, from_idx) - take(static.y, to_idx))
    dy = torch.minimum(dy, MAX_Y - dy)
    d2 = dx * dx + dy * dy
    # float32 sqrt may be 1 ulp off; snap to the exact integer sqrt so the
    # table lookups stay bit-exact with the scalar path
    s = torch.sqrt(d2.to(torch.float32)).to(torch.int32)
    s = torch.where((s + 1) * (s + 1) <= d2, s + 1, s)
    s = torch.where(s * s > d2, s - 1, s)
    return s


class NetworkLatencyByDistanceWJitter(NetworkLatency):
    """RTT = 0.022 * miles + 4.862 plus GPD(ξ=1.4, μ=-0.3, σ=0.35) jitter,
    halved for one-way (NetworkLatency.java:49-73)."""

    EARTH_PERIMETER = 24_860
    POINT_VALUE = (EARTH_PERIMETER / 2) / MAX_DIST

    # Exact-table trick: dist is an int <= MAX_DIST and delta < 100, so the
    # whole model is a [MAX_DIST+1, 100] int32 table computed in float64 on
    # the host; the kernel is a single gather, bit-exact with the scalar
    # path.
    _TABLE = None
    _ON_DEVICE: dict = {}

    @classmethod
    def _table(cls) -> np.ndarray:
        if cls._TABLE is None:
            dists = np.arange(MAX_DIST + 1, dtype=np.float64)
            fixed = dists * (cls.POINT_VALUE * 0.022) + 4.862
            raw = fixed[:, None] + JITTER_TABLE[None, :]
            cls._TABLE = (raw / 2).astype(np.int32)  # trunc toward zero (>0)
        return cls._TABLE

    @classmethod
    def _table_on(cls, device: torch.device) -> torch.Tensor:
        """The flattened table, uploaded once per device."""
        key = str(device)
        if key not in cls._ON_DEVICE:
            cls._ON_DEVICE[key] = torch.from_numpy(cls._table().reshape(-1)).to(device)
        return cls._ON_DEVICE[key]

    def ext_vec(self, static, from_idx, to_idx, delta):
        table = self._table_on(static.x.device)
        dist = _dist_vec(static, from_idx, to_idx)
        return table[(dist * 100 + delta).to(torch.int64)]
