"""Weight initializers, after ``paddle_tpu/nn/initializer.py``.

An initializer fills a tensor in place: ``init(tensor, generator=None)``.
Every draw is made in f32 on the tensor's device and then cast to its
dtype, from an explicit ``torch.Generator``: the caller's, else the next
one of ``framework.random.next_generator`` on that device. torch's global
generator is never read. The fan rules are the reference's: ``[in, out]``
for a 2-D weight (paddle's ``Linear`` layout), ``[out, in, *kernel]`` for a
convolution's.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..framework import random as _random

__all__ = [
    "Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
    "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
    "Assign", "calculate_gain",
]


def _fans(shape):
    """(fan_in, fan_out) of a parameter of ``shape``."""
    shape = tuple(shape)
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


def calculate_gain(nonlinearity, param=None):
    if nonlinearity in ("sigmoid", "linear", "conv1d", "conv2d", "conv3d"):
        return 1.0
    if nonlinearity == "tanh":
        return 5.0 / 3
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a**2))
    if nonlinearity == "selu":
        return 3.0 / 4
    return 1.0


class Initializer:
    """Fills ``tensor`` in place (under no grad) and returns it."""

    def __call__(self, tensor, generator=None):
        with torch.no_grad():
            if tensor.numel():
                self._fill(tensor, generator)
        return tensor

    def _fill(self, tensor, generator):
        raise NotImplementedError

    @staticmethod
    def _draw(tensor, generator, sample):
        """``sample(f32 buffer, generator)`` on the tensor's device, then
        copied into ``tensor`` in its dtype."""
        gen = generator or _random.next_generator(tensor.device)
        buf = torch.empty(tensor.shape, device=tensor.device,
                          dtype=torch.float32)
        sample(buf, gen)
        tensor.copy_(buf)


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _fill(self, tensor, generator):
        tensor.fill_(self.value)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _fill(self, tensor, generator):
        self._draw(tensor, generator, lambda b, g: b.normal_(
            self.mean, self.std, generator=g))


class TruncatedNormal(Initializer):
    """``mean + std * x``, x a standard normal truncated to ``[a, b]``
    (the reference's bounds are in standard units)."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def _fill(self, tensor, generator):
        def sample(buf, gen):
            # inverse CDF of the truncated standard normal over a uniform
            # draw, so one pass makes every value
            lo = 0.5 * (1 + math.erf(self.a / math.sqrt(2)))
            hi = 0.5 * (1 + math.erf(self.b / math.sqrt(2)))
            buf.uniform_(lo, hi, generator=gen)
            buf.mul_(2).sub_(1).clamp_(-1 + 1e-7, 1 - 1e-7).erfinv_()
            buf.mul_(math.sqrt(2)).clamp_(self.a, self.b)
            buf.mul_(self.std).add_(self.mean)
        self._draw(tensor, generator, sample)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def _fill(self, tensor, generator):
        self._draw(tensor, generator, lambda b, g: b.uniform_(
            self.low, self.high, generator=g))


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _fill(self, tensor, generator):
        fi, fo = _fans(tensor.shape)
        std = self.gain * math.sqrt(2.0 / ((self.fan_in or fi)
                                           + (self.fan_out or fo)))
        self._draw(tensor, generator, lambda b, g: b.normal_(
            0.0, std, generator=g))


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _fill(self, tensor, generator):
        fi, fo = _fans(tensor.shape)
        limit = self.gain * math.sqrt(6.0 / ((self.fan_in or fi)
                                             + (self.fan_out or fo)))
        self._draw(tensor, generator, lambda b, g: b.uniform_(
            -limit, limit, generator=g))


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in, self.negative_slope = fan_in, negative_slope
        self.nonlinearity = nonlinearity

    def _fill(self, tensor, generator):
        fi = self.fan_in or _fans(tensor.shape)[0]
        std = calculate_gain(self.nonlinearity, self.negative_slope) \
            / math.sqrt(fi)
        self._draw(tensor, generator, lambda b, g: b.normal_(
            0.0, std, generator=g))


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in, self.negative_slope = fan_in, negative_slope
        self.nonlinearity = nonlinearity

    def _fill(self, tensor, generator):
        fi = self.fan_in or _fans(tensor.shape)[0]
        limit = calculate_gain(self.nonlinearity, self.negative_slope) \
            * math.sqrt(3.0 / fi)
        self._draw(tensor, generator, lambda b, g: b.uniform_(
            -limit, limit, generator=g))


class Assign(Initializer):
    """Copies ``value`` (array-like or tensor of the parameter's shape)."""

    def __init__(self, value):
        self.value = value

    def _fill(self, tensor, generator):
        src = torch.as_tensor(np.asarray(self.value)
                              if not isinstance(self.value, torch.Tensor)
                              else self.value)
        if tuple(src.shape) != tuple(tensor.shape):
            raise ValueError(f"Assign shape {tuple(src.shape)} != "
                             f"{tuple(tensor.shape)}")
        tensor.copy_(src)
