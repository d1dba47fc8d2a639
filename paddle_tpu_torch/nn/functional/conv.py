"""Convolutions, after ``paddle_tpu/nn/functional/conv.py``.

Weights keep paddle's layout (``[out, in/groups, *k]``; the transposed
conv ``[in, out/groups, kh, kw]``), activations are channel-first unless
``data_format`` says channel-last (permuted to channel-first and back).
``torch.nn.functional.conv*d`` computes them (cuDNN on the card): the
reference computes them with ``lax.conv_general_dilated`` outside any
Pallas kernel.

Padding follows lax: an int or a per-dim int pads both sides, per-dim
``(lo, hi)`` pairs pad each side, ``"VALID"`` pads nothing and ``"SAME"``
pads ``max((ceil(n/s) - 1)*s + d*(k-1) + 1 - n, 0)`` with the odd row on
the high side. torch refuses ``padding="same"`` at stride > 1, so the
port computes those pads itself and applies uneven ones with ``F.pad``.
"""
from __future__ import annotations

import torch.nn.functional as tF

from ...amp import amp_cast

__all__ = ["conv1d", "conv2d", "conv3d", "conv2d_transpose"]

_CHANNEL_LAST = ("NHWC", "NLC", "NHC", "NDHWC")


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(v)
    return (v,) * n


def _pads(padding, n, in_sizes, kernel, stride, dilation):
    """lax's ``(lo, hi)`` pad of each spatial dim."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return [(0, 0)] * n
        if mode != "SAME":
            raise ValueError(f"unknown padding {padding!r}")
        pads = []
        for size, k, s, d in zip(in_sizes, kernel, stride, dilation):
            out = -(-size // s)
            total = max((out - 1) * s + d * (k - 1) + 1 - size, 0)
            pads.append((total // 2, total - total // 2))
        return pads
    p = _pair(padding, n)
    if len(p) == n and not any(isinstance(v, (list, tuple)) for v in p):
        return [(int(v), int(v)) for v in p]
    return [tuple(int(v) for v in pp) for pp in p]


def _conv(fn, x, weight, bias, stride, padding, dilation, groups, n,
          data_format, op):
    x, weight = amp_cast(op, x, weight)
    s, d = _pair(stride, n), _pair(dilation, n)
    last = data_format in _CHANNEL_LAST
    if last:
        x = x.movedim(-1, 1)
    pads = _pads(padding, n, x.shape[2:], weight.shape[2:], s, d)
    fused = bias if bias is not None and bias.dtype == x.dtype else None
    if all(lo == hi for lo, hi in pads):
        out = fn(x, weight, fused, s, [lo for lo, _ in pads], d, groups)
    else:
        flat = [v for lo_hi in reversed(pads) for v in lo_hi]
        out = fn(tF.pad(x, flat), weight, fused, s, 0, d, groups)
    if bias is not None and fused is None:
        out = out + bias.reshape((1, -1) + (1,) * n)
    return out.movedim(1, -1) if last else out


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv(tF.conv2d, x, weight, bias, stride, padding, dilation,
                 groups, 2, data_format, "conv2d")


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv(tF.conv1d, x, weight, bias, stride, padding, dilation,
                 groups, 1, data_format, "conv1d")


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv(tF.conv3d, x, weight, bias, stride, padding, dilation,
                 groups, 3, data_format, "conv3d")


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     output_size=None, data_format="NCHW"):
    """Transposed conv, weight ``[in, out/groups, kh, kw]``; out_hw =
    (in-1)*s - 2*p + d*(k-1) + output_padding + 1, or ``output_size``."""
    x, weight = amp_cast("conv2d", x, weight)
    s, d, p = _pair(stride), _pair(dilation), _pair(padding)
    k = tuple(weight.shape[-2:])
    last = data_format == "NHWC"
    if last:
        x = x.movedim(-1, 1)
    in_hw = x.shape[2:4]
    if output_size is not None:
        osz = _pair(output_size)
        op = tuple(osz[i] - ((in_hw[i] - 1) * s[i] - 2 * p[i]
                             + d[i] * (k[i] - 1) + 1) for i in range(2))
    else:
        op = _pair(output_padding)
    if any(o < 0 or o >= s[i] for i, o in enumerate(op)):
        raise ValueError(
            f"conv2d_transpose: invalid output_padding {op} for stride {s}")
    out = tF.conv_transpose2d(x, weight, None, s, p, op, groups, d)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out.movedim(1, -1) if last else out
