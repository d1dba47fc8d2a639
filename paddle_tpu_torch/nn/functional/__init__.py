"""Functional ops of the port (after ``paddle_tpu.nn.functional``)."""
from __future__ import annotations

import torch

from .attention import flash_attention, naive_attention
from .norm import rms_norm

__all__ = ["linear", "embedding", "silu", "rms_norm", "flash_attention",
           "naive_attention"]


def linear(x, weight):
    """y = x W with W ``[in, out]`` (paddle layout)."""
    return torch.matmul(x, weight)


def embedding(ids, weight):
    return weight[ids]


def silu(x):
    return torch.nn.functional.silu(x)
