"""Common layers, after ``paddle_tpu/nn/common.py``: ``Linear`` keeps the
paddle weight layout ``[in_features, out_features]`` (y = x W + b), so a
``paddle_tpu`` state dict loads with no transposes; ``Embedding`` is a
``[num_embeddings, embedding_dim]`` table; ``Dropout`` draws its mask
from an explicit ``torch.Generator``.

Weights are drawn on the given device with the reference's defaults:
``Linear`` XavierNormal and a zero bias, ``Embedding`` Normal(0, 1); a
``weight_attr`` / ``bias_attr`` (a ``ParamAttr`` or an initializer) with
an initializer overrides them. Draws come from the next generator of
``framework.random`` (a ``Linear``'s from ``generator`` when one is
given).
"""
from __future__ import annotations

import torch
from torch import nn

from . import functional as F
from . import initializer as I
from .layer import Layer

__all__ = ["Linear", "Embedding", "Dropout"]


class Linear(Layer):
    """y = x W + b, weight ``[in_features, out_features]``, bias
    ``[out_features]``. ``bias_attr=False`` drops the bias (the LLaMA
    convention), as in the reference."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__(dtype=dtype)
        self.in_features, self.out_features = in_features, out_features
        kw = dict(device=device, generator=generator)
        self.weight = self.create_parameter(
            (in_features, out_features), attr=weight_attr,
            default_initializer=I.XavierNormal(), **kw)
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter(
                (out_features,), attr=bias_attr, is_bias=True, **kw)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self.in_features}, " \
               f"out_features={self.out_features}, " \
               f"bias={self.bias is not None}"


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, *, weight_attr=None,
                 name=None, device=None, dtype=torch.float32):
        super().__init__(dtype=dtype)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = self.create_parameter(
            (num_embeddings, embedding_dim), attr=weight_attr,
            default_initializer=I.Normal(0.0, 1.0), device=device)

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
