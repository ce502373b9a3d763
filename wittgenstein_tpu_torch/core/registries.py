"""Name-keyed lookup of the default node builder and latency model.

Reference semantics: core RegistryNodeBuilders.java and
RegistryNetworkLatencies.java.  The port registers only the defaults the
Handel main path resolves (`node_builder_name=None`,
`network_latency_name=None`); any other name raises, so a configuration
the port cannot yet reproduce fails loudly instead of running another
model.
"""

from __future__ import annotations

from typing import Optional

from .latency import NetworkLatency, NetworkLatencyByDistanceWJitter
from .node import NodeBuilder, NodeBuilderWithRandomPosition

RANDOM = "RANDOM"
DEFAULT_LATENCY = "NetworkLatencyByDistanceWJitter"


def builder_name(location: str, speed_constant: bool, tor: float) -> str:
    """Exact name format of RegistryNodeBuilders.name (the non-constant
    speed model is named GAUSSIAN, the reference's quirk at
    RegistryNodeBuilders.java:24-27)."""
    speed = "CONSTANT" if speed_constant else "GAUSSIAN"
    tor_s = (repr(float(tor)) + "000")[:4]
    return f"{location}_speed={speed}_tor={tor_s}".upper()


DEFAULT_BUILDER = builder_name(RANDOM, True, 0.0)


class RegistryNodeBuilders:
    def get_by_name(self, name: Optional[str]) -> NodeBuilder:
        if name is None or not name.strip():
            name = DEFAULT_BUILDER
        if name != DEFAULT_BUILDER:
            raise NotImplementedError(
                f"node builder {name!r} is not ported; only {DEFAULT_BUILDER}"
            )
        return NodeBuilderWithRandomPosition()


class RegistryNetworkLatencies:
    def get_by_name(self, name: Optional[str]) -> NetworkLatency:
        if name is None:
            name = DEFAULT_LATENCY
        if name != DEFAULT_LATENCY:
            raise NotImplementedError(
                f"latency model {name!r} is not ported; only {DEFAULT_LATENCY}"
            )
        return NetworkLatencyByDistanceWJitter()


registry_node_builders = RegistryNodeBuilders()
registry_network_latencies = RegistryNetworkLatencies()
