"""Map geometry constants (reference: core geoinfo/Geo.java).

Only what the default RANDOM node builder needs: the Mercator map bounds
and the default city name.  City tables arrive with the city-based
builders in a later slice.
"""

from __future__ import annotations

import math

MAX_X = 2000
MAX_Y = 1112
MAX_DIST = int(math.sqrt((MAX_X / 2.0) ** 2 + (MAX_Y / 2.0) ** 2))
DEFAULT_CITY = "world"
