"""Map geometry and the AWS-region city table (reference: core
geoinfo/Geo.java, GeoAWS.java, CityInfo.java).

What the node builders need: the Mercator map bounds, the default city
name, the 11 AWS-region cities with their positions and cumulative
sampling probabilities, and the all-cities table (`GeoAllCities`, 241
cities with population weights) with the 219 city names of the
reference's ping CSVs (`latency_cities`, CSVLatencyReader.cities()).  The
port keeps its own copy of those two tables, names, positions and
populations only, in data/cities.json; it carries no ping matrix.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Dict, List, Tuple

MAX_X = 2000
MAX_Y = 1112
MAX_DIST = int(math.sqrt((MAX_X / 2.0) ** 2 + (MAX_Y / 2.0) ** 2))
DEFAULT_CITY = "world"


@dataclasses.dataclass(frozen=True)
class CityInfo:
    merc_x: int
    merc_y: int
    cumulative_probability: float


class Geo:
    def cities_position(self) -> Dict[str, CityInfo]:
        raise NotImplementedError

    @staticmethod
    def city_info_map(
        cities: Dict[str, Tuple[int, int, int]], total_population: int
    ) -> Dict[str, CityInfo]:
        """cities: name -> (mercX, mercY, population).  The cumulative
        probability accumulates in the dict's insertion order (Geo.java:11-19
        iterates a HashMap; the JAX package fixes the order this way)."""
        cum = 0.0
        out: Dict[str, CityInfo] = {}
        for name, (x, y, pop) in cities.items():
            cum += pop * 1.0 / total_population
            out[name] = CityInfo(x, y, cum)
        return out


class GeoAWS(Geo):
    """Positions of the 11 AWS-region cities (GeoAWS.java:10-23)."""

    CITY_POS: Dict[str, Tuple[int, int, int]] = {
        "Oregon": (271, 261, 1),
        "Virginia": (513, 316, 1),
        "Mumbai": (1344, 426, 1),
        "Seoul": (1641, 312, 1),
        "Singapore": (1507, 532, 1),
        "Sydney": (1773, 777, 1),
        "Tokyo": (1708, 316, 1),
        "Canada central": (422, 256, 1),
        "Frankfurt": (985, 226, 1),
        "Ireland": (891, 200, 1),
        "London": (937, 205, 1),
    }

    def cities_position(self) -> Dict[str, CityInfo]:
        return self.city_info_map(self.CITY_POS, len(self.CITY_POS))


_CITIES_JSON = Path(__file__).resolve().parent.parent / "data" / "cities.json"
_CITIES: dict = {}


def _cities_data() -> dict:
    if not _CITIES:
        _CITIES.update(json.loads(_CITIES_JSON.read_text()))
    return _CITIES


def latency_cities() -> List[str]:
    """The city names of the reference's ping CSVs, in the JAX package's
    order (CSVLatencyReader().cities(), tools/latency_csv.py:45)."""
    return list(_cities_data()["latency_cities"])


class GeoAllCities(Geo):
    """All 241 cities of the reference's cities.csv with population-weighted
    probability (GeoAllCities.java:41-55: positions converted to Mercator,
    population + 200000), in the JAX package's baked order."""

    def __init__(self):
        g = _cities_data()["geo_cities"]
        cities = {n: (x, y, p) for n, x, y, p in
                  zip(g["names"], g["merc_x"], g["merc_y"], g["population"])}
        total = sum(v[2] for v in cities.values())
        self._positions = self.city_info_map(cities, total)

    def cities_position(self) -> Dict[str, CityInfo]:
        return dict(self._positions)
