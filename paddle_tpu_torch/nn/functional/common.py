"""Common functions, after ``paddle_tpu/nn/functional/common.py``."""
from __future__ import annotations

import torch

from ...amp import amp_cast

__all__ = ["linear", "dropout", "embedding"]


def linear(x, weight, bias=None):
    """y = x W + b with W ``[in, out]`` (paddle layout)."""
    x, weight = amp_cast("linear", x, weight)
    if bias is None:
        return torch.matmul(x, weight)
    (bias,) = amp_cast("linear", bias)
    return torch.matmul(x, weight) + bias


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            generator=None):
    """Zero each element (or each slice along ``axis``) with probability
    ``p``; the mask is drawn from ``generator`` (a ``torch.Generator`` on
    x's device; the default generator when None)."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if axis is None:
        shape = x.shape
    else:
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        shape = tuple(x.shape[i] if i in axes else 1 for i in range(x.dim()))
    keep = torch.rand(shape, generator=generator, device=x.device) >= p
    out = torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                           device=x.device))
    if mode == "upscale_in_train":
        out = out / (1.0 - p)
    return out


def embedding(ids, weight):
    return weight[ids]
