"""Common layers, after ``paddle_tpu/nn/common.py``: ``Linear`` keeps the
paddle weight layout ``[in_features, out_features]`` (y = x W), so a
``paddle_tpu`` state dict loads with no transposes; ``Embedding`` is a
``[num_embeddings, embedding_dim]`` table.

Parameters are allocated uninitialised on the given device; the model's
initialiser (``convert.init_llama``) or a loaded state dict fills them.
"""
from __future__ import annotations

import torch
from torch import nn

from . import functional as F

__all__ = ["Linear", "Embedding"]


class Linear(nn.Module):
    """y = x W, weight ``[in_features, out_features]``, no bias (the
    LLaMA convention, ``bias_attr=False`` in the reference)."""

    def __init__(self, in_features, out_features, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight = nn.Parameter(torch.empty(
            (in_features, out_features), device=device, dtype=dtype))

    def forward(self, x):
        return F.linear(x, self.weight)

    def extra_repr(self):
        return f"in_features={self.in_features}, " \
               f"out_features={self.out_features}"


class Embedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = nn.Parameter(torch.empty(
            (num_embeddings, embedding_dim), device=device, dtype=dtype))

    def forward(self, x):
        return F.embedding(x, self.weight)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"
