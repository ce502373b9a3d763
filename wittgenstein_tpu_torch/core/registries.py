"""Name-keyed lookup of the ported node builders and latency models.

Reference semantics: core RegistryNodeBuilders.java and
RegistryNetworkLatencies.java.  The port registers the defaults
(`node_builder_name=None`, `network_latency_name=None`), the AWS builder
`builder_name("AWS", True, 0.0)`, the all-cities builder
`builder_name("CITIES", True, 0.0)` (ETHPoW's miner environment), the `AwsRegionNetworkLatency`,
`IC3NetworkLatency` and `NetworkNoLatency` models, and the fixed and
uniform models the JAX package pre-registers (`name(FIXED, f)` and
`name(UNIFORM, f)` for f in 0..8000); any other name raises, so a
configuration the port cannot yet reproduce fails loudly instead of
running another model.
"""

from __future__ import annotations

from typing import Optional

from .geo import GeoAllCities, GeoAWS, latency_cities
from .latency import (
    AwsRegionNetworkLatency,
    IC3NetworkLatency,
    NetworkFixedLatency,
    NetworkLatency,
    NetworkLatencyByDistanceWJitter,
    NetworkNoLatency,
    NetworkUniformLatency,
)
from .node import NodeBuilder, NodeBuilderWithCity, NodeBuilderWithRandomPosition

AWS = "AWS"
CITIES = "CITIES"
RANDOM = "RANDOM"
DEFAULT_LATENCY = "NetworkLatencyByDistanceWJitter"
LATENCY_CLASSES = {
    DEFAULT_LATENCY: NetworkLatencyByDistanceWJitter,
    "AwsRegionNetworkLatency": AwsRegionNetworkLatency,
    "IC3NetworkLatency": IC3NetworkLatency,
    "NetworkNoLatency": NetworkNoLatency,
}


def builder_name(location: str, speed_constant: bool, tor: float) -> str:
    """Exact name format of RegistryNodeBuilders.name (the non-constant
    speed model is named GAUSSIAN, the reference's quirk at
    RegistryNodeBuilders.java:24-27)."""
    speed = "CONSTANT" if speed_constant else "GAUSSIAN"
    tor_s = (repr(float(tor)) + "000")[:4]
    return f"{location}_speed={speed}_tor={tor_s}".upper()


DEFAULT_BUILDER = builder_name(RANDOM, True, 0.0)
AWS_BUILDER = builder_name(AWS, True, 0.0)
CITIES_BUILDER = builder_name(CITIES, True, 0.0)


class RegistryNodeBuilders:
    def get_by_name(self, name: Optional[str]) -> NodeBuilder:
        """A fresh builder (node ids from 0) for a ported name."""
        if name is None or not name.strip():
            name = DEFAULT_BUILDER
        if name == DEFAULT_BUILDER:
            return NodeBuilderWithRandomPosition()
        if name == AWS_BUILDER:
            return NodeBuilderWithCity(AwsRegionNetworkLatency.cities(), GeoAWS())
        if name == CITIES_BUILDER:
            # core/registries.py:128-131 of the JAX package
            return NodeBuilderWithCity(latency_cities(), GeoAllCities())
        raise NotImplementedError(
            f"node builder {name!r} is not ported; only {DEFAULT_BUILDER}, {AWS_BUILDER} "
            f"and {CITIES_BUILDER}"
        )


class RegistryNetworkLatencies:
    FIXED = "FIXED"
    UNIFORM = "UNIFORM"
    # the values RegistryNetworkLatencies.java pre-registers for both
    PRESET = (0, 100, 200, 500, 1000, 2000, 4000, 8000)

    @staticmethod
    def name(type_: str, fixed: int) -> str:
        if type_ == RegistryNetworkLatencies.FIXED:
            return f"NetworkFixedLatency({fixed})"
        if type_ == RegistryNetworkLatencies.UNIFORM:
            return f"NetworkUniformLatency({fixed})"
        raise ValueError(type_)

    def get_by_name(self, name: Optional[str]) -> NetworkLatency:
        if name is None:
            name = DEFAULT_LATENCY
        for f in self.PRESET:
            if name == self.name(self.FIXED, f):
                return NetworkFixedLatency(f)
            if name == self.name(self.UNIFORM, f):
                return NetworkUniformLatency(f)
        cls = LATENCY_CLASSES.get(name)
        if cls is None:
            raise NotImplementedError(
                f"latency model {name!r} is not ported; only {sorted(LATENCY_CLASSES)} "
                f"and the fixed and uniform models at {self.PRESET}"
            )
        return cls()


registry_node_builders = RegistryNodeBuilders()
registry_network_latencies = RegistryNetworkLatencies()
