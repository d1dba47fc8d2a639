"""Normalisation functions, after ``paddle_tpu/nn/functional/norm.py``.
Both compute in f32 and cast back to x's dtype."""
from __future__ import annotations

import torch

__all__ = ["rms_norm", "layer_norm"]


def rms_norm(x, weight=None, epsilon=1e-6, axis=-1):
    xf = x.float()
    ms = torch.mean(xf * xf, dim=axis, keepdim=True)
    out = xf * torch.rsqrt(ms + epsilon)
    if weight is not None:
        out = out * weight.float()
    return out.to(x.dtype)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """Layer norm over the trailing ``normalized_shape`` dims (biased
    variance, as ``jnp.var``)."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    out = torch.nn.functional.layer_norm(
        x.float(), tuple(normalized_shape),
        weight.float() if weight is not None else None,
        bias.float() if bias is not None else None, epsilon)
    return out.to(x.dtype)
