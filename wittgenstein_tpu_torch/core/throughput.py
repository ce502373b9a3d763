"""TCP throughput-aware delay (the Mathis equation).

Reference semantics: core NetworkThroughput.java:17-57.  `delay` is the
scalar form on Python floats; `vec_delay` the engine's form on tensors,
in float32 as the JAX package computes it.
"""

from __future__ import annotations

import math

import torch

from ..utils.javaops import jint
from .latency import NetworkLatency, vec_latency


class NetworkThroughput:
    def delay(self, from_node, to_node, delta: int, msg_size: int, nl=None) -> int:
        """`nl` is the owning network's latency model; implementations
        price off it when it is given."""
        raise NotImplementedError


class MathisNetworkThroughput(NetworkThroughput):
    MSS = 1460
    LOSS = 0.004

    def __init__(self, nl: NetworkLatency, window_size_bytes: int = 87380 * 1024):
        self.nl = nl
        self.window_size = 8 * window_size_bytes
        self._div = math.sqrt(self.LOSS)

    def delay(self, from_node, to_node, delta: int, msg_size: int, nl=None) -> int:
        """The size-dependent delay; `nl` (default: the constructor's
        model) prices it off the owning network's latency model."""
        st = (nl or self.nl).get_latency(from_node, to_node, delta)
        if msg_size < self.MSS:
            return st
        rtt = st * 2.0
        bandwidth = (self.MSS * 8) / (rtt * self._div)
        w_max = self.window_size / rtt
        av_bandwidth = min(bandwidth, w_max)
        return jint((8 * msg_size) / av_bandwidth + st)

    def vec_delay(self, static, from_idx, to_idx, delta, msg_size, nl=None):
        """delay() over index tensors, in float32 as the JAX package's
        form (so it may differ from the float64 scalar form by 1 ms on
        large bandwidth-bound messages).  `msg_size` is an int or a
        tensor that broadcasts against the indices.  Every step rounds as
        the JAX form's does: a Python float operand is taken as float32,
        and each quotient is a true division of a float32 numerator
        filled on the device (no reciprocal, no host copy)."""
        st = vec_latency(nl or self.nl, static, from_idx, to_idx, delta)
        stf = st.to(torch.float32)
        rtt = stf * 2.0
        bandwidth = torch.full_like(rtt, self.MSS * 8.0).div_(rtt * self._div)
        w_max = torch.full_like(rtt, float(self.window_size)).div_(rtt)
        av_bandwidth = torch.minimum(bandwidth, w_max)
        if isinstance(msg_size, torch.Tensor):
            bits = msg_size.to(torch.float32) * 8.0
            big = (bits / av_bandwidth + stf).to(torch.int32)
            return torch.where(msg_size < self.MSS, st, big)
        if msg_size < self.MSS:
            return st
        bits = torch.full_like(av_bandwidth, 8.0 * msg_size)
        return (bits.div_(av_bandwidth) + stf).to(torch.int32)
