"""Normalisation layers, after ``paddle_tpu/nn/norm.py``.

The batch norms keep the reference's names: ``weight`` (ones), ``bias``
(zeros) and the f32 buffers ``_mean`` (zeros) and ``_variance`` (ones),
which training updates as ``F.batch_norm`` says (``momentum`` weighs the
old value).
"""
from __future__ import annotations

import torch
from torch import nn

from . import functional as F

__all__ = ["RMSNorm", "LayerNorm", "BatchNorm", "BatchNorm1D",
           "BatchNorm2D", "BatchNorm3D", "GroupNorm", "InstanceNorm2D"]


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


class _BatchNormBase(nn.Module):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.num_features = num_features
        self.momentum, self.epsilon = momentum, epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        kw = dict(device=device, dtype=dtype)
        self.weight = None if weight_attr is False else nn.Parameter(
            torch.ones((num_features,), **kw))
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.zeros((num_features,), **kw))
        self.register_buffer("_mean", torch.zeros(
            (num_features,), device=device, dtype=torch.float32))
        self.register_buffer("_variance", torch.ones(
            (num_features,), device=device, dtype=torch.float32))

    def forward(self, x):
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self.momentum,
            epsilon=self.epsilon, data_format=self.data_format,
            use_global_stats=self.use_global_stats)

    def extra_repr(self):
        return f"num_features={self.num_features}, " \
               f"momentum={self.momentum}, epsilon={self.epsilon}"


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class GroupNorm(nn.Module):
    """Group norm over channel-first inputs (the reference's layer ignores
    ``data_format``, so a channel-last one is refused)."""

    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, device=None, dtype=torch.float32):
        super().__init__()
        if data_format in ("NHWC", "NLC", "NDHWC", "NHC"):
            raise ValueError(f"GroupNorm: data_format={data_format!r} is "
                             "not supported (the reference's layer runs "
                             "channel-first)")
        self.num_groups, self.epsilon = num_groups, epsilon
        kw = dict(device=device, dtype=dtype)
        self.weight = None if weight_attr is False else nn.Parameter(
            torch.ones((num_channels,), **kw))
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.zeros((num_channels,), **kw))

    def forward(self, x):
        return F.group_norm(x, self.num_groups, self.weight, self.bias,
                            self.epsilon)


class InstanceNorm2D(nn.Module):
    """Group norm with one group a channel, as in the reference."""

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, device=None, dtype=torch.float32):
        super().__init__()
        self.num_features, self.epsilon = num_features, epsilon
        kw = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.ones((num_features,), **kw))
        self.bias = nn.Parameter(torch.zeros((num_features,), **kw))

    def forward(self, x):
        return F.group_norm(x, self.num_features, self.weight, self.bias,
                            self.epsilon)
