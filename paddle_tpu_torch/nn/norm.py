"""Normalisation layers, after ``paddle_tpu/nn/norm.py``."""
from __future__ import annotations

import torch
from torch import nn

from . import functional as F

__all__ = ["RMSNorm"]


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
