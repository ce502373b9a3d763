"""Node identity, the node aspects and the node builders.

Reference semantics: core Node.java (identity, position, aspects) and
NodeBuilder.java (id allocation, random positions, weighted city
choice).  A node draws one `rd.next_int()` (its position, or its city
and the city's position), then its builder's speed-ratio aspect, then
its extra-latency aspect (Node.java:265-266), each only if the builder
carries it — the same JavaRandom stream, draw for draw, as the JAX
package's builders.  `build_node_columns` turns the population into the
struct-of-arrays columns the batched engine reads.
"""

from __future__ import annotations

import copy as _copy
import math
from typing import Dict, List, Optional

import numpy as np

from ..utils.gpd import GeneralizedParetoDistribution
from ..utils.javaops import i32, java_abs, java_mod, lshift32
from ..utils.javarand import JavaRandom
from .geo import DEFAULT_CITY, MAX_X, MAX_Y, CityInfo, Geo


class Aspect:
    """An optional per-node attribute sampler (Node.java:145-244)."""

    def get_value(self, rd: JavaRandom):
        return None


class ExtraLatencyAspect(Aspect):
    """Tor-style extra latency: 500 ms with probability `ratio`."""

    def __init__(self, ratio: float):
        self.ratio = ratio

    def get_value(self, rd: JavaRandom):
        return 500 if rd.next_double() < self.ratio else 0


class SpeedRatioAspect(Aspect):
    def __init__(self, speed_model: "SpeedModel"):
        self.sm = speed_model

    def get_value(self, rd: JavaRandom):
        return self.sm.get_speed_ratio(rd)


class SpeedModel:
    def get_speed_ratio(self, rd: JavaRandom) -> float:
        raise NotImplementedError


class ParetoSpeed(SpeedModel):
    def __init__(self, shape: float, location: float, scale: float, max_: float):
        self.gpd = GeneralizedParetoDistribution(shape, location, scale)
        self.max = max_

    def get_speed_ratio(self, rd: JavaRandom) -> float:
        return min(self.max, 1.0 + self.gpd.inverse_f(rd.next_double()))


class GaussianSpeed(SpeedModel):
    def get_speed_ratio(self, rd: JavaRandom) -> float:
        return max(0.33, rd.next_gaussian() + 1)


class UniformSpeed(SpeedModel):
    """Uniform from 3x faster to 3x slower (Node.java:233-244)."""

    def get_speed_ratio(self, rd: JavaRandom) -> float:
        if rd.next_boolean():
            return (rd.next_int(67) + 33) / 100.0
        return (rd.next_int(200) + 100) / 100.0


def _aspect_value(aspect_cls, aspects: List[Aspect], rd: JavaRandom, default):
    """The first aspect of exactly `aspect_cls` draws; else `default`."""
    for a in aspects:
        if type(a) is aspect_cls:
            return a.get_value(rd)
    return default


class Node:
    __slots__ = (
        "node_id",
        "x",
        "y",
        "extra_latency",
        "byzantine",
        "speed_ratio",
        "city_name",
    )

    def __init__(self, rd: JavaRandom, nb: "NodeBuilder", byzantine: bool = False):
        self.node_id = nb.allocate_node_id()
        if self.node_id < 0:
            raise ValueError(f"bad nodeId: {self.node_id}")
        rd_node = rd.next_int()
        self.city_name = nb.get_city_name(rd_node)
        self.x = nb.get_x(rd_node)
        self.y = nb.get_y(rd_node)
        if not (0 < self.x <= MAX_X):
            raise ValueError(f"bad x={self.x}")
        if not (0 < self.y <= MAX_Y):
            raise ValueError(f"bad y={self.y}")
        self.byzantine = byzantine
        # speed first, then extra latency: the reference's draw order
        self.speed_ratio = float(_aspect_value(SpeedRatioAspect, nb.aspects, rd, 1.0))
        self.extra_latency = int(_aspect_value(ExtraLatencyAspect, nb.aspects, rd, 0))
        if self.speed_ratio <= 0:
            raise ValueError(f"speedRatio={self.speed_ratio}")

    def dist(self, other: "Node") -> int:
        """Toroidal map distance, truncated to an int (Node.java:278-282)."""
        dx = min(abs(self.x - other.x), MAX_X - abs(self.x - other.x))
        dy = min(abs(self.y - other.y), MAX_Y - abs(self.y - other.y))
        return int(math.sqrt(dx * dx + dy * dy))

    def __repr__(self) -> str:
        return f"Node{{nodeId={self.node_id}}}"


class NodeBuilder:
    def __init__(self):
        self._node_ids = 0
        self.aspects: List[Aspect] = []

    def copy(self) -> "NodeBuilder":
        """The same builder with node ids reset (NodeBuilder.java:42-52);
        the aspects are shared, as in the Java shallow clone."""
        nb = _copy.copy(self)
        nb._node_ids = 0
        return nb

    def allocate_node_id(self) -> int:
        nid = self._node_ids
        self._node_ids += 1
        return nid

    def get_x(self, rd_int: int) -> int:
        return 1

    def get_y(self, rd_int: int) -> int:
        return 1

    def get_city_name(self, rd_int: int) -> str:
        return DEFAULT_CITY


class NodeBuilderWithRandomPosition(NodeBuilder):
    """Position from the high/low 16 bits of one random int
    (NodeBuilder.java:77-96, including the int32 overflow on the y path)."""

    def get_x(self, rd_int: int) -> int:
        r = abs(rd_int >> 16)  # arithmetic shift, then abs as 64-bit
        return r % MAX_X + 1

    def get_y(self, rd_int: int) -> int:
        r = abs(lshift32(rd_int, 16))
        return r % MAX_Y + 1


class NodeBuilderWithCity(NodeBuilder):
    """Weighted-random city choice (NodeBuilder.java:98-148): the city
    from one random int against the cumulative probabilities, the
    position from the city."""

    def __init__(self, cities: List[str], geo: Geo):
        super().__init__()
        self.cities = [c.upper() for c in cities]
        wanted = set(self.cities)
        self.cities_info: Dict[str, CityInfo] = {
            k: v for k, v in geo.cities_position().items() if k.upper() in wanted
        }

    def get_city_name(self, rd_int: int) -> str:
        name = self._random_city(rd_int)
        if name is None:
            raise ValueError("no city matched")
        return name

    def _random_city(self, rd_int: int) -> Optional[str]:
        size = len(self.cities)
        p = java_mod(java_abs(i32(rd_int)), size) / size
        for name, info in self.cities_info.items():
            if p <= info.cumulative_probability:
                return name
        return None

    def get_x(self, rd_int: int) -> int:
        return self.cities_info[self.get_city_name(rd_int)].merc_x

    def get_y(self, rd_int: int) -> int:
        return self.cities_info[self.get_city_name(rd_int)].merc_y


def build_node_columns(nodes: List[Node], city_index: Dict[str, int] | None = None):
    """Convert built Node objects into the static struct-of-arrays columns the
    batched engine consumes.  city_index maps cityName -> int for city-matrix
    latency models (absent cities map to -1)."""
    n = len(nodes)
    cols = {
        "x": np.array([nd.x for nd in nodes], dtype=np.int32),
        "y": np.array([nd.y for nd in nodes], dtype=np.int32),
        "extra_latency": np.array([nd.extra_latency for nd in nodes], dtype=np.int32),
        "speed_ratio": np.array([nd.speed_ratio for nd in nodes], dtype=np.float32),
        "byzantine": np.array([nd.byzantine for nd in nodes], dtype=bool),
        "city_idx": np.full(n, -1, dtype=np.int32),
    }
    if city_index:
        for idx, nd in enumerate(nodes):
            cols["city_idx"][idx] = city_index.get(nd.city_name, -1)
    return cols
