"""Common layers, after ``paddle_tpu/nn/common.py``: ``Linear`` keeps the
paddle weight layout ``[in_features, out_features]`` (y = x W + b), so a
``paddle_tpu`` state dict loads with no transposes; ``Embedding`` is a
``[num_embeddings, embedding_dim]`` table; ``Dropout`` draws its mask
from an explicit ``torch.Generator``.

Weights are allocated uninitialised on the given device; the model's
initialiser (``convert.init_llama`` / ``init_gpt``) or a loaded state
dict fills them. A ``Linear`` bias starts at zeros, as the reference's.
"""
from __future__ import annotations

import torch
from torch import nn

from . import functional as F

__all__ = ["Linear", "Embedding", "Dropout"]


class Linear(nn.Module):
    """y = x W + b, weight ``[in_features, out_features]``, bias
    ``[out_features]``. ``bias_attr=False`` drops the bias (the LLaMA
    convention), as in the reference."""

    def __init__(self, in_features, out_features, bias_attr=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight = nn.Parameter(torch.empty(
            (in_features, out_features), device=device, dtype=dtype))
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = nn.Parameter(torch.zeros(
                (out_features,), device=device, dtype=dtype))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self.in_features}, " \
               f"out_features={self.out_features}, " \
               f"bias={self.bias is not None}"


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


class Dropout(nn.Module):
    """Dropout with probability ``p`` in training mode; the mask comes from
    ``generator`` (a ``torch.Generator`` on the activations' device, the
    default generator when None)."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train",
                 generator=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis, training=self.training,
                         mode=self.mode, generator=self.generator)

    def extra_repr(self):
        return f"p={self.p}"
