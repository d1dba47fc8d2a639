"""Normalisation layers, after ``paddle_tpu/nn/norm.py``."""
from __future__ import annotations

import torch
from torch import nn

from . import functional as F

__all__ = ["RMSNorm", "LayerNorm"]


class RMSNorm(nn.Module):
    """Root-mean-square norm with a learned scale (initialised to ones)."""

    def __init__(self, hidden_size, epsilon=1e-6, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones((hidden_size,), device=device,
                                              dtype=dtype))

    def forward(self, x):
        return F.rms_norm(x, self.weight, epsilon=self.epsilon)


class LayerNorm(nn.Module):
    """Layer norm with a learned scale (ones) and shift (zeros); either is
    dropped by ``weight_attr=False`` / ``bias_attr=False``."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, device=None, dtype=torch.float32):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        kw = dict(device=device, dtype=dtype)
        self.weight = None if weight_attr is False else nn.Parameter(
            torch.ones(self.normalized_shape, **kw))
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.zeros(self.normalized_shape, **kw))

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}, " \
               f"epsilon={self.epsilon}"
