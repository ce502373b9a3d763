"""Name-keyed lookup of the ported node builders and latency models.

Reference semantics: core RegistryNodeBuilders.java and
RegistryNetworkLatencies.java.  The port registers the defaults
(`node_builder_name=None`, `network_latency_name=None`), the AWS builder
`builder_name("AWS", True, 0.0)`, and the `AwsRegionNetworkLatency` and
`IC3NetworkLatency` models; any other name raises, so a configuration
the port cannot yet reproduce fails loudly instead of running another
model.
"""

from __future__ import annotations

from typing import Optional

from .geo import GeoAWS
from .latency import (
    AwsRegionNetworkLatency,
    IC3NetworkLatency,
    NetworkLatency,
    NetworkLatencyByDistanceWJitter,
)
from .node import NodeBuilder, NodeBuilderWithCity, NodeBuilderWithRandomPosition

AWS = "AWS"
RANDOM = "RANDOM"
DEFAULT_LATENCY = "NetworkLatencyByDistanceWJitter"
LATENCY_CLASSES = {
    DEFAULT_LATENCY: NetworkLatencyByDistanceWJitter,
    "AwsRegionNetworkLatency": AwsRegionNetworkLatency,
    "IC3NetworkLatency": IC3NetworkLatency,
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


class RegistryNodeBuilders:
    def get_by_name(self, name: Optional[str]) -> NodeBuilder:
        """A fresh builder (node ids from 0) for a ported name."""
        if name is None or not name.strip():
            name = DEFAULT_BUILDER
        if name == DEFAULT_BUILDER:
            return NodeBuilderWithRandomPosition()
        if name == AWS_BUILDER:
            return NodeBuilderWithCity(AwsRegionNetworkLatency.cities(), GeoAWS())
        raise NotImplementedError(
            f"node builder {name!r} is not ported; only {DEFAULT_BUILDER} and {AWS_BUILDER}"
        )


class RegistryNetworkLatencies:
    def get_by_name(self, name: Optional[str]) -> NetworkLatency:
        if name is None:
            name = DEFAULT_LATENCY
        cls = LATENCY_CLASSES.get(name)
        if cls is None:
            raise NotImplementedError(
                f"latency model {name!r} is not ported; only {sorted(LATENCY_CLASSES)}"
            )
        return cls()


registry_node_builders = RegistryNodeBuilders()
registry_network_latencies = RegistryNetworkLatencies()
