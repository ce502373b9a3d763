"""Generalized Pareto distribution — closed-form inverse CDF.

Matches the reference implementation semantics
(core utils/GeneralizedParetoDistribution.java:31-47): clamping near 0/1 and
the three-branch inverse.  Host-side only: the latency model bakes its
jitter table from it once (core/latency.py JITTER_TABLE).
"""

from __future__ import annotations

import math

_ONE = 0.999999
_ZERO = 0.000001


class GeneralizedParetoDistribution:
    __slots__ = ("shape", "location", "scale")

    def __init__(self, shape: float, location: float, scale: float):
        if scale <= 0.0:
            raise ValueError(f"scale={scale}")
        self.shape = shape
        self.location = location
        self.scale = scale

    def inverse_f(self, y: float) -> float:
        if y < 0.0 or y > 1.0:
            raise ValueError(f"y={y}")
        if y < _ZERO:
            return self.location
        if y > _ONE:
            if self.shape >= 0:
                return math.inf
            return self.location - self.scale / self.shape
        if abs(self.shape) < _ZERO:
            return self.location - self.scale * math.log1p(-y)
        return self.location + self.scale / self.shape * (-1 + (1 - y) ** -self.shape)
