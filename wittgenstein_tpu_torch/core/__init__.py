"""Host-side construction: node population, geometry, latency, registries."""
