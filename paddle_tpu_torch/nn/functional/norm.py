"""Normalisation functions, after ``paddle_tpu/nn/functional/norm.py``."""
from __future__ import annotations

import torch

__all__ = ["rms_norm"]


def rms_norm(x, weight=None, epsilon=1e-6, axis=-1):
    """RMSNorm computed in f32 and cast back to x's dtype."""
    xf = x.float()
    ms = torch.mean(xf * xf, dim=axis, keepdim=True)
    out = xf * torch.rsqrt(ms + epsilon)
    if weight is not None:
        out = out * weight.float()
    return out.to(x.dtype)
