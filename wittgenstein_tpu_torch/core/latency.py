"""Network latency models, vectorized over the replica axis.

Reference semantics: core NetworkLatency.java.  The port keeps all ten
models of the JAX package: the default `NetworkLatencyByDistanceWJitter`
with its exact host table, `AwsRegionNetworkLatency` (the AWS-region
ping matrix), `NetworkLatencyByCity` and `NetworkLatencyByCityWJitter`
(the wondernetwork city matrix, tools/latency_csv.py),
`MeasuredNetworkLatency` and `EthScanNetworkLatency` (100-bucket
measured distributions), `IC3NetworkLatency` (area quantiles of the
distance), and the fixed, uniform and no-latency models, with the shared
`vec_latency` wrapper (NetworkLatency.getLatency,
NetworkLatency.java:27-34) and the toroidal distance with its
integer-sqrt snap.  All randomness is externalized into `delta` in
[0, 99], which the engine draws from its counter RNG.

Every column is [R, N] and every index array [R, ...]: the replica axis
is explicit (see ops/indexing.py).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..ops.indexing import take
from ..utils.gpd import GeneralizedParetoDistribution
from ..utils.javaops import java_int_div, jint, jround
from .geo import DEFAULT_CITY, MAX_DIST, MAX_X, MAX_Y

_WAN_GPD = GeneralizedParetoDistribution(1.4, -0.3, 0.35)
# delta only ever takes 100 values: precompute the jitter table once.
JITTER_TABLE = np.array([_WAN_GPD.inverse_f(d / 100.0) for d in range(100)])

_ON_DEVICE: dict = {}


def _on_device(key: str, host: np.ndarray, device: torch.device) -> torch.Tensor:
    """A model's host table as a flat tensor, uploaded once per device."""
    k = (key, str(device))
    if k not in _ON_DEVICE:
        _ON_DEVICE[k] = torch.from_numpy(np.ascontiguousarray(host).reshape(-1)).to(device)
    return _ON_DEVICE[k]


class NetworkLatency:
    def get_extended_latency(self, from_node, to_node, delta: int) -> int:
        raise NotImplementedError

    def _check_delta(self, delta: int) -> None:
        if delta < 0 or delta > 99:
            raise ValueError(f"delta={delta}")

    def get_latency(self, from_node, to_node, delta: int) -> int:
        """The scalar getLatency (NetworkLatency.java:27-34)."""
        if from_node is to_node:
            return 1
        base = from_node.extra_latency + to_node.extra_latency
        base += self.get_extended_latency(from_node, to_node, delta)
        return max(1, base)

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

    @classmethod
    def _table(cls) -> np.ndarray:
        if cls._TABLE is None:
            dists = np.arange(MAX_DIST + 1, dtype=np.float64)
            fixed = dists * (cls.POINT_VALUE * 0.022) + 4.862
            raw = fixed[:, None] + JITTER_TABLE[None, :]
            cls._TABLE = (raw / 2).astype(np.int32)  # trunc toward zero (>0)
        return cls._TABLE

    def ext_vec(self, static, from_idx, to_idx, delta):
        table = _on_device("distance_jitter", self._table(), static.x.device)
        dist = _dist_vec(static, from_idx, to_idx)
        return table[(dist * 100 + delta).to(torch.int64)]


def _wrapped(idx: torch.Tensor, size: int) -> torch.Tensor:
    """A table index as JAX's gather reads it: a negative index counts
    from the end (a node outside the city index, -1, reads the last
    city), and never a negative address on the device."""
    return torch.remainder(idx, size).to(torch.int64)


AWS_REGION_PER_CITY: Dict[str, int] = {
    "Oregon": 0,
    "Virginia": 1,
    "Mumbai": 2,
    "Seoul": 3,
    "Singapore": 4,
    "Sydney": 5,
    "Tokyo": 6,
    "Canada central": 7,
    "Frankfurt": 8,
    "Ireland": 9,
    "London": 10,
}

# upper-triangular ping matrix, ms round trip (NetworkLatency.java:112-128)
_AWS_PINGS = np.array(
    [
        [0, 81, 216, 126, 165, 138, 97, 64, 164, 131, 141],
        [0, 0, 182, 181, 232, 195, 167, 13, 88, 80, 75],
        [0, 0, 0, 152, 62, 223, 123, 194, 111, 122, 113],
        [0, 0, 0, 0, 97, 133, 35, 184, 259, 254, 264],
        [0, 0, 0, 0, 0, 169, 69, 218, 162, 174, 171],
        [0, 0, 0, 0, 0, 0, 105, 210, 282, 269, 271],
        [0, 0, 0, 0, 0, 0, 0, 156, 235, 222, 234],
        [0, 0, 0, 0, 0, 0, 0, 0, 101, 78, 87],
        [0, 0, 0, 0, 0, 0, 0, 0, 0, 24, 13],
        [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 12],
        [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    ],
    dtype=np.int32,
)


class AwsRegionNetworkLatency(NetworkLatency):
    """One-way latency between AWS regions: half the ping, plus the WAN
    jitter truncated to an int, at least 1; 1 within a region
    (NetworkLatency.java:100-160).

    The vectorized form reads each node's region from `city_idx`.  The
    JAX package's builders fill that column only for a model with a
    `city_index`, which this one lacks, so on the batched path every node
    holds -1, every pair compares equal, and every latency is 1 ms.  The
    port reproduces that: -1 wraps to the last region as JAX's indexing
    does, and the `r1 == r2` branch then answers 1."""

    # symmetric one-way base: ping // 2 (diagonal 0, same region apart)
    ONEWAY = np.maximum(_AWS_PINGS, _AWS_PINGS.T) // 2
    # the jitter as the JAX form adds it: float32, truncated toward zero
    JITTER_I32 = JITTER_TABLE.astype(np.float32).astype(np.int32)

    @staticmethod
    def cities():
        return sorted(AWS_REGION_PER_CITY)

    def ext_vec(self, static, from_idx, to_idx, delta):
        dev = static.x.device
        m = _on_device("aws_oneway", self.ONEWAY, dev)
        jit = _on_device("aws_jitter", self.JITTER_I32, dev)
        regions = self.ONEWAY.shape[0]
        r1 = take(static.city_idx, from_idx)
        r2 = take(static.city_idx, to_idx)
        lat = torch.clamp(m[_wrapped(r1, regions) * regions + _wrapped(r2, regions)]
                          + jit[delta.to(torch.int64)], min=1)
        # the same-region test on the indices as stored, as JAX compares them
        return torch.where(r1 == r2, 1, lat)


class NetworkLatencyByCity(NetworkLatency):
    """Half the city-to-city round trip, rounded, at least 1
    (NetworkLatency.java:165-198).  The vectorized form reads each node's
    city from `city_idx`, which the builders fill from `city_index`."""

    def __init__(self, reader=None):
        if reader is None:
            from ..tools.latency_csv import CSVLatencyReader

            reader = CSVLatencyReader()
        self._index = reader.city_index()
        self._matrix = reader.matrix()

    @property
    def city_index(self):
        return self._index

    def _city_lat(self, city_from: str, city_to: str) -> float:
        return float(self._matrix[self._index[city_from], self._index[city_to]])

    def _check_cities(self, from_node, to_node) -> None:
        if DEFAULT_CITY in (from_node.city_name, to_node.city_name):
            raise ValueError("Can't use NetworkLatencyByCity model with default city location")

    def get_extended_latency(self, from_node, to_node, delta: int) -> int:
        if from_node.node_id == to_node.node_id:
            return 1
        self._check_cities(from_node, to_node)
        raw = np.float32(0.5) * np.float32(self._city_lat(from_node.city_name, to_node.city_name))
        return max(1, jround(float(raw)))

    def _pair(self, static, from_idx, to_idx):
        """(c1, c2, m[c1, c2]) with JAX's reading of a -1 city."""
        c = self._matrix.shape[0]
        m = _on_device("city_matrix", self._matrix, static.city_idx.device)
        c1 = take(static.city_idx, from_idx)
        c2 = take(static.city_idx, to_idx)
        return c1, c2, m[_wrapped(c1, c) * c + _wrapped(c2, c)]

    def ext_vec(self, static, from_idx, to_idx, delta):
        _, _, m = self._pair(static, from_idx, to_idx)
        lat = torch.clamp(torch.floor(m * 0.5 + 0.5).to(torch.int32), min=1)
        return torch.where(from_idx == to_idx, 1, lat)


class NetworkLatencyByCityWJitter(NetworkLatencyByCity):
    """The city matrix plus the WAN jitter, same-city round trip taken as
    10 ms (NetworkLatency.java:200-233).  The vectorized form computes in
    float32, as the JAX form does: base + jitter, then floor(0.5 * raw +
    0.5), at least 1."""

    SAME_CITY_RTT = 10.0
    JITTER_F32 = JITTER_TABLE.astype(np.float32)

    def get_extended_latency(self, from_node, to_node, delta: int) -> int:
        if from_node.node_id == to_node.node_id:
            return 1
        self._check_cities(from_node, to_node)
        raw = float(JITTER_TABLE[delta])
        if from_node.city_name == to_node.city_name:
            raw += self.SAME_CITY_RTT
        else:
            raw += self._city_lat(from_node.city_name, to_node.city_name)
        return max(1, jint(jround(0.5 * raw)))

    def ext_vec(self, static, from_idx, to_idx, delta):
        c1, c2, m = self._pair(static, from_idx, to_idx)
        jit = _on_device("city_jitter", self.JITTER_F32, m.device)
        # the same-city test on the indices as stored: -1 meets only -1
        base = torch.where(c1 == c2, torch.tensor(self.SAME_CITY_RTT, dtype=torch.float32,
                                                   device=m.device), m)
        raw = base + jit[delta.to(torch.int64)]
        lat = torch.clamp(torch.floor(raw * 0.5 + 0.5).to(torch.int32), min=1)
        return torch.where(from_idx == to_idx, 1, lat)


class MeasuredNetworkLatency(NetworkLatency):
    """A measured distribution as a 100-bucket inverse CDF
    (NetworkLatency.java:270-310): the latency is bucket `delta`."""

    def __init__(self, distrib_prop, distrib_val):
        self.long_distrib = self._set_latency(distrib_prop, distrib_val)
        # the JAX form reads the int64 table as int32
        self._table = self.long_distrib.astype(np.int32)
        self._key = "measured:" + ",".join(map(str, self._table.tolist()))

    @staticmethod
    def _set_latency(proportions, values) -> np.ndarray:
        """Integer-step interpolation with Java's int division into an
        int64 table (NetworkLatency.java:284-303)."""
        out = np.zeros(100, dtype=np.int64)
        li = 0
        cur = 0
        total = 0
        for prop, val in zip(proportions, values):
            if prop == 0:
                cur = val
                continue
            total += prop
            step = java_int_div(val - cur, prop)
            for _ in range(prop):
                cur += step
                out[li] = cur
                li += 1
        if total != 100 or li != 100:
            raise ValueError("proportions must sum to 100")
        return out

    def get_extended_latency(self, from_node, to_node, delta: int) -> int:
        self._check_delta(delta)
        return int(self.long_distrib[delta])

    def ext_vec(self, static, from_idx, to_idx, delta):
        return _on_device(self._key, self._table, delta.device)[delta.to(torch.int64)]


class EthScanNetworkLatency(NetworkLatency):
    """EthStats' block-propagation distribution
    (NetworkLatency.java:360-378).  The reference delegates to
    MeasuredNetworkLatency.getLatency, which adds the extra latencies and
    clamps inside; both forms keep that (extras count twice)."""

    DISTRIB_PROP = [16, 18, 17, 12, 8, 5, 4, 3, 3, 1, 1, 2, 1, 1, 8]
    DISTRIB_VAL = [
        250, 500, 1000, 1250, 1500, 1750, 2000, 2250, 2500, 2750,
        4500, 6000, 8500, 9750, 10000,
    ]

    def __init__(self):
        self._m = MeasuredNetworkLatency(self.DISTRIB_PROP, self.DISTRIB_VAL)

    def get_extended_latency(self, from_node, to_node, delta: int) -> int:
        return self._m.get_latency(from_node, to_node, delta)

    def ext_vec(self, static, from_idx, to_idx, delta):
        return vec_latency(self._m, static, from_idx, to_idx, delta)


class IC3NetworkLatency(NetworkLatency):
    """Half the round trip of the distance's area quantile
    (NetworkLatency.java:374-410): the share of the map inside the disc of
    the distance picks one of six IC3 measurements."""

    S10 = 92
    SW = 350
    _TABLE = None

    @classmethod
    def _table(cls) -> np.ndarray:
        """The exact per-distance table, computed in float64 on the host."""
        if cls._TABLE is None:
            out = np.empty(MAX_DIST + 1, dtype=np.int32)
            for dist in range(MAX_DIST + 1):
                position = jint((float(dist) * dist * math.pi * 100) / (MAX_X * MAX_Y))
                if position <= 10:
                    out[dist] = cls.S10 // 2
                elif position <= 33:
                    out[dist] = 125 // 2
                elif position <= 50:
                    out[dist] = 152 // 2
                elif position <= 67:
                    out[dist] = 200 // 2
                elif position <= 90:
                    out[dist] = 276 // 2
                else:
                    out[dist] = cls.SW // 2
            cls._TABLE = out
        return cls._TABLE

    def ext_vec(self, static, from_idx, to_idx, delta):
        table = _on_device("ic3", self._table(), static.x.device)
        return table[_dist_vec(static, from_idx, to_idx).to(torch.int64)]


class NetworkFixedLatency(NetworkLatency):
    """The same latency for every pair, at least 1 ms
    (NetworkLatency.java, NetworkFixedLatency)."""

    def __init__(self, fixed_latency: int):
        self.fixed_latency = max(1, fixed_latency)

    def get_extended_latency(self, from_node, to_node, delta: int) -> int:
        return self.fixed_latency

    def ext_vec(self, static, from_idx, to_idx, delta):
        return torch.full(from_idx.shape, self.fixed_latency, dtype=torch.int32,
                          device=from_idx.device)

    def __str__(self):
        return f"fixedLatency:{self.fixed_latency}"


class NetworkUniformLatency(NetworkLatency):
    """`(int)((delta / 99.0) * max)`: uniform over [0, max]
    (NetworkLatency.java, NetworkUniformLatency).  The JAX form computes it in float32,
    so the vectorized form reads a host table of the 100 float32 results,
    the same on every device (no reciprocal rewrite of the division)."""

    def __init__(self, max_latency: int):
        self.max_latency = max(1, max_latency)
        d = np.arange(100, dtype=np.float32)
        self._table = ((d / np.float32(99.0)) * np.float32(self.max_latency)).astype(np.int32)

    def get_extended_latency(self, from_node, to_node, delta: int) -> int:
        return jint((delta / 99.0) * self.max_latency)

    def ext_vec(self, static, from_idx, to_idx, delta):
        table = _on_device(f"uniform{self.max_latency}", self._table, from_idx.device)
        return table[delta.to(torch.int64)]

    def __str__(self):
        return f"NetworkUniformLatency:{self.max_latency}"


class NetworkNoLatency(NetworkLatency):
    """1 ms for every pair (NetworkLatency.java, NetworkNoLatency)."""

    def get_extended_latency(self, from_node, to_node, delta: int) -> int:
        return 1

    def ext_vec(self, static, from_idx, to_idx, delta):
        return torch.ones(from_idx.shape, dtype=torch.int32, device=from_idx.device)
