"""The city-to-city ping matrix (reference: tools/CSVLatencyReader.java).

The port reads its own copy of the matrix baked from the reference's
wondernetwork ping CSVs, `data/city_latency.npz`: 219 city names and a
219 x 219 float32 matrix of round-trip ms, resolved (the from-side
measurement, else the to-side one) with the reference's same-city 30 ms
on the diagonal.  It does not parse the CSV tree; a missing file raises.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List

import numpy as np

BAKED = Path(__file__).resolve().parent.parent / "data" / "city_latency.npz"


class CSVLatencyReader:
    """The reference's `.cities()` and `.get_latency(from, to)` over the
    baked matrix."""

    def __init__(self):
        if not BAKED.exists():
            raise FileNotFoundError(f"the baked city latency matrix is missing: {BAKED}")
        with np.load(BAKED, allow_pickle=False) as z:
            self._names = [str(s) for s in z["names"]]
            self._matrix = z["matrix"].astype(np.float32)
        self._index = {n: i for i, n in enumerate(self._names)}

    def cities(self) -> List[str]:
        return list(self._names)

    def city_index(self) -> Dict[str, int]:
        return dict(self._index)

    def matrix(self) -> np.ndarray:
        """Dense [C, C] float32."""
        return self._matrix

    def get_latency(self, city_from: str, city_to: str) -> float:
        return float(self._matrix[self._index[city_from], self._index[city_to]])
