"""Normalisation layers, after ``paddle_tpu/nn/norm.py``.

The batch norms keep the reference's names: ``weight`` (ones), ``bias``
(zeros) and the f32 buffers ``_mean`` (zeros) and ``_variance`` (ones),
which training updates as ``F.batch_norm`` says (``momentum`` weighs the
old value).

``SyncBatchNorm`` takes the batch statistics over the whole data-parallel
batch. The reference gets that from SPMD (a batch norm over the sharded
batch); here each rank is a process, so in training each rank sums its
count, sum and sum of squares a channel, in f32, and one all-reduce over
the group (``fcollectives.all_reduce``: its backward all-reduces the
gradient) gives every rank the global mean and biased variance. Without a
group of more than one rank it is ``BatchNorm``.
"""
from __future__ import annotations

import torch
from torch import nn

from . import functional as F
from .functional.norm import _CHANNEL_LAST

__all__ = ["RMSNorm", "LayerNorm", "BatchNorm", "BatchNorm1D",
           "BatchNorm2D", "BatchNorm3D", "SyncBatchNorm", "GroupNorm",
           "InstanceNorm2D"]


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


class SyncBatchNorm(_BatchNormBase):
    """Batch norm over the global batch of a data-parallel ``group``
    (None: fleet's ``dp`` group when fleet laid the world out, else the
    world); see the module doc."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, group=None, device=None, dtype=torch.float32):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, None, name, device, dtype)
        self._group = group

    def _sync_group(self):
        import torch.distributed as dist

        if self._group is not None:
            return self._group
        if not dist.is_initialized():
            return None
        from ..distributed.fleet.fleet_base import fleet_state

        if fleet_state.initialized:
            return fleet_state.hcg.get_data_parallel_group()
        from ..distributed.parallel import get_group

        return get_group()

    def forward(self, x):
        group = self._sync_group() if self.training else None
        if group is None or group.nranks <= 1:
            return super().forward(x)
        return self._summed_norm(x, group)

    def _summed_norm(self, x, group):
        """Training batch norm from each channel's count, sum and sum of
        squares, summed over ``group`` (None: this rank's batch alone)."""
        from ..distributed.collective import fcollectives

        last = self.data_format in _CHANNEL_LAST and x.dim() > 2
        xf = (x.movedim(-1, 1) if last else x).float()
        dims = [i for i in range(xf.dim()) if i != 1]
        count = torch.full((1,), xf.numel() / xf.shape[1],
                           dtype=torch.float32, device=xf.device)
        stats = torch.cat([xf.sum(dims), (xf * xf).sum(dims), count])
        if group is not None:
            stats = fcollectives.all_reduce(stats, group)
        c = self.num_features
        n = stats[2 * c]
        mean = stats[:c] / n
        var = (stats[c:2 * c] / n - mean * mean).clamp_min(0.0)
        shape = [1] * xf.dim()
        shape[1] = c
        out = (xf - mean.view(shape)) * torch.rsqrt(var.view(shape)
                                                   + self.epsilon)
        if self.weight is not None:
            out = out * self.weight.float().view(shape)
        if self.bias is not None:
            out = out + self.bias.float().view(shape)
        with torch.no_grad():
            for buf, stat in ((self._mean, mean), (self._variance, var)):
                buf.copy_(self.momentum * buf.float()
                          + (1 - self.momentum) * stat.detach())
        out = out.to(x.dtype)
        return out.movedim(1, -1) if last else out

    @classmethod
    def convert_sync_batchnorm(cls, layer, group=None):
        """``layer`` with every batch norm (``_BatchNormBase``) below it
        replaced, in place, by a ``SyncBatchNorm`` holding the same
        parameters and buffers; a batch norm ``layer`` itself is returned
        converted."""
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, cls):
            w = layer.weight
            ref = w if w is not None else layer._mean
            sbn = cls(layer.num_features, layer.momentum, layer.epsilon,
                      weight_attr=False if w is None else None,
                      bias_attr=False if layer.bias is None else None,
                      data_format=layer.data_format, group=group,
                      device=ref.device,
                      dtype=w.dtype if w is not None else torch.float32)
            sbn.weight, sbn.bias = layer.weight, layer.bias
            sbn._mean, sbn._variance = layer._mean, layer._variance
            sbn.train(layer.training)
            return sbn
        for name, child in list(layer.named_children()):
            new = cls.convert_sync_batchnorm(child, group)
            if new is not child:
                setattr(layer, name, new)
        return layer


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
