"""Pooling, after ``paddle_tpu/nn/functional/pooling.py``, on
``torch.nn.functional``'s pools (the reference uses ``lax.reduce_window``
outside any Pallas kernel). Inputs are channel-first.

The reference ignores some arguments: ``ceil_mode``, ``return_mask`` and
``data_format`` of the max pools, ``ceil_mode`` and ``data_format`` of
the average pools, ``return_mask`` of ``adaptive_max_pool2d``. Rather
than give them torch's meaning, the port refuses any value but the
default. ``avg_pool1d`` divides by the window whatever ``exclusive``
says, as the reference does. Max pools pad with -inf.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tF

__all__ = ["max_pool2d", "avg_pool2d", "max_pool1d", "avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool1d",
           "adaptive_max_pool2d"]


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


def _one(v):
    return v if isinstance(v, int) else v[0]


def _defaults_only(fn, **given):
    """Refuse the arguments the reference accepts and ignores."""
    defaults = {"ceil_mode": False, "return_mask": False,
                "data_format": ("NCHW", "NCL")}
    for name, value in given.items():
        ok = defaults[name]
        if value not in (ok if isinstance(ok, tuple) else (ok,)):
            raise ValueError(
                f"{fn}: {name}={value!r} is not supported (the reference "
                "ignores it); pass the default")


def _max_pool(x, k, s, p):
    """``max_pool{1,2}d`` with -inf padding of any width (torch's own
    padding stops at half the window)."""
    nd = len(k)
    pool = tF.max_pool2d if nd == 2 else tF.max_pool1d
    if all(pi <= ki // 2 for pi, ki in zip(p, k)):
        return pool(x, k, s, p)
    flat = [v for pi in reversed(p) for v in (pi, pi)]
    return pool(tF.pad(x, flat, value=float("-inf")), k, s, 0)


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW"):
    _defaults_only("max_pool2d", ceil_mode=ceil_mode,
                   return_mask=return_mask, data_format=data_format)
    k = _pair(kernel_size)
    s = _pair(stride if stride is not None else kernel_size)
    return _max_pool(x, k, s, _pair(padding))


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW"):
    """``exclusive`` leaves the padding out of each window's count (torch's
    ``count_include_pad=False``)."""
    _defaults_only("avg_pool2d", ceil_mode=ceil_mode,
                   data_format=data_format)
    k = _pair(kernel_size)
    s = _pair(stride if stride is not None else kernel_size)
    p = _pair(padding)
    if divisor_override:
        summed = tF.avg_pool2d(x, k, s, p, count_include_pad=True,
                               divisor_override=1)
        return summed / divisor_override
    return tF.avg_pool2d(x, k, s, p, count_include_pad=not exclusive)


def max_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False):
    _defaults_only("max_pool1d", ceil_mode=ceil_mode,
                   return_mask=return_mask)
    k = _one(kernel_size)
    s = k if stride is None else _one(stride)
    return _max_pool(x, (k,), (s,), (_one(padding),))


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False):
    _defaults_only("avg_pool1d", ceil_mode=ceil_mode)
    k = _one(kernel_size)
    s = k if stride is None else _one(stride)
    return tF.avg_pool1d(x, k, s, _one(padding), count_include_pad=True)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    """Sizes that divide pool with a window of ``h/oh x w/ow``; others
    average the disjoint buckets ``linspace(0, n, o + 1).astype(int)``
    (not ``F.adaptive_avg_pool2d``'s overlapping floor/ceil windows)."""
    _defaults_only("adaptive_avg_pool2d", data_format=data_format)
    oh, ow = _pair(output_size)
    h, w = x.shape[-2:]
    if h % oh == 0 and w % ow == 0:
        k = (h // oh, w // ow)
        return tF.avg_pool2d(x, k, k)
    hs = np.linspace(0, h, oh + 1).astype(int)
    ws = np.linspace(0, w, ow + 1).astype(int)
    rows = [torch.stack([x[..., hs[i]:hs[i + 1], ws[j]:ws[j + 1]]
                         .mean(dim=(-1, -2)) for j in range(ow)], dim=-1)
            for i in range(oh)]
    return torch.stack(rows, dim=-2)


def adaptive_avg_pool1d(x, output_size):
    o = _one(output_size)
    n = x.shape[-1]
    if n % o:
        raise ValueError(f"adaptive_avg_pool1d: length {n} is not a "
                         f"multiple of {o}")
    return x.reshape(*x.shape[:-1], o, n // o).mean(-1)


def adaptive_max_pool2d(x, output_size, return_mask=False):
    _defaults_only("adaptive_max_pool2d", return_mask=return_mask)
    oh, ow = _pair(output_size)
    h, w = x.shape[-2:]
    if h % oh or w % ow:
        raise ValueError(f"adaptive_max_pool2d: {h}x{w} is not a multiple "
                         f"of {oh}x{ow}")
    k = (h // oh, w // ow)
    return tF.max_pool2d(x, k, k)
