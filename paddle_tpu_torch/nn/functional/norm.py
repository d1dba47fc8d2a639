"""Normalisation functions, after ``paddle_tpu/nn/functional/norm.py``.
Each computes in f32 and casts back to x's dtype.

``batch_norm`` in training normalises with the batch's statistics and
updates the running buffers in place, without grad, the reference's way:
``running = momentum * running + (1 - momentum) * batch``, where the
batch variance is the biased one (``jnp.var``). torch's own buffer update
weighs the new value by ``momentum`` and keeps the unbiased variance, so
the port computes the normalisation with ``F.batch_norm`` and no running
statistics, and the statistics for the buffers with ``torch.var_mean``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as tF

__all__ = ["batch_norm", "layer_norm", "group_norm", "rms_norm",
           "local_response_norm"]

_CHANNEL_LAST = ("NHWC", "NLC", "NDHWC", "NHC")


def _f32(t):
    return None if t is None else t.float()


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None):
    """Batch norm over every dim but the channel's; in training the
    running buffers are updated in place."""
    last = data_format in _CHANNEL_LAST and x.dim() > 2
    xf = (x.movedim(-1, 1) if last else x).float()
    use_stats = (not training) if use_global_stats is None \
        else use_global_stats
    if use_stats:
        out = tF.batch_norm(xf, running_mean.float(), running_var.float(),
                            _f32(weight), _f32(bias), False, 0.0, epsilon)
    else:
        out = tF.batch_norm(xf, None, None, _f32(weight), _f32(bias), True,
                            0.0, epsilon)
        with torch.no_grad():
            dims = [i for i in range(xf.dim()) if i != 1]
            var, mean = torch.var_mean(xf, dim=dims, unbiased=False)
            for buf, stat in ((running_mean, mean), (running_var, var)):
                buf.copy_(momentum * buf.float() + (1 - momentum) * stat)
    out = out.to(x.dtype)
    return out.movedim(1, -1) if last else out


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """Layer norm over the trailing ``normalized_shape`` dims (biased
    variance, as ``jnp.var``)."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    out = tF.layer_norm(x.float(), tuple(normalized_shape), _f32(weight),
                        _f32(bias), epsilon)
    return out.to(x.dtype)


def rms_norm(x, weight=None, epsilon=1e-6, axis=-1):
    xf = x.float()
    ms = torch.mean(xf * xf, dim=axis, keepdim=True)
    out = xf * torch.rsqrt(ms + epsilon)
    if weight is not None:
        out = out * weight.float()
    return out.to(x.dtype)


def group_norm(x, num_groups, weight=None, bias=None, epsilon=1e-5,
               data_format="NCHW"):
    """Group norm; the affine applies only when both ``weight`` and
    ``bias`` are given, as in the reference."""
    last = data_format in _CHANNEL_LAST
    xf = (x.movedim(-1, 1) if last else x).float()
    affine = weight is not None and bias is not None
    out = tF.group_norm(xf, num_groups, _f32(weight) if affine else None,
                        _f32(bias) if affine else None, epsilon)
    out = out.to(x.dtype)
    return out.movedim(1, -1) if last else out


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW"):
    """``x / (k + alpha * s / size) ** beta``, ``s`` the sum of squares
    over a window of ``size`` channels (``size // 2`` before, the rest
    after). This is the reference's public ``F.local_response_norm``
    (``nn/functional/extras.py``, which shadows the form in its
    ``norm.py`` that does not divide by ``size``). Channel-first only: the
    reference ignores ``data_format``."""
    if data_format in _CHANNEL_LAST:
        raise ValueError(f"local_response_norm: data_format={data_format!r}"
                         " is not supported (the reference ignores it)")
    half = size // 2
    sq = tF.pad(x * x, (0, 0) * (x.dim() - 2) + (half, size - 1 - half))
    c = x.shape[1]
    summed = sum(sq[:, i:i + c] for i in range(size))
    return x / torch.pow(k + alpha * summed / size, beta)
