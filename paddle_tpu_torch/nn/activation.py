"""Activation layers, after ``paddle_tpu/nn/activation.py`` (the ones the
port's models use)."""
from __future__ import annotations

from torch import nn

from . import functional as F

__all__ = ["ReLU"]


class ReLU(nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu(x)
