"""Activations, after ``paddle_tpu/nn/functional/activation.py``."""
from __future__ import annotations

import torch

__all__ = ["silu", "gelu", "relu", "tanh"]


def silu(x):
    return torch.nn.functional.silu(x)


def relu(x):
    return torch.relu(x)


def gelu(x, approximate=False):
    """GELU; ``approximate=True`` is the tanh form (``jax.nn.gelu``'s)."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def tanh(x):
    return torch.tanh(x)
