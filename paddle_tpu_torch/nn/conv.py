"""Conv layers, after ``paddle_tpu/nn/conv.py``. Weights keep paddle's
layout, ``[out, in/groups, *kernel]`` (``Conv2DTranspose``: ``[in,
out/groups, kh, kw]``), so a ``paddle_tpu`` state dict loads with no
transposes. The weight is drawn KaimingNormal (std ``sqrt(2 / fan_in)``,
fan_in ``in/groups * prod(kernel)``) from ``generator`` (the next one of
``framework.random.next_generator`` when None); a bias starts at zeros.
``bias_attr=False`` drops the bias.
"""
from __future__ import annotations

import torch
from torch import nn

from . import functional as F
from . import initializer as I
from .layer import make_parameter

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv2DTranspose"]


def _ntuple(v, n):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


def _kaiming(shape, device, dtype, generator):
    return make_parameter(shape, dtype=dtype, device=device,
                          default_initializer=I.KaimingNormal(),
                          generator=generator)


class _ConvNd(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, nd, stride,
                 padding, dilation, groups, padding_mode, bias_attr,
                 data_format, device, dtype, generator, fn):
        super().__init__()
        if padding_mode != "zeros":
            raise ValueError(f"padding_mode={padding_mode!r} is not "
                             "supported (the reference pads with zeros)")
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size = _ntuple(kernel_size, nd)
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.groups = groups
        self.data_format = data_format
        self._fn = fn
        shape = (out_channels, in_channels // groups) + self.kernel_size
        self.weight = _kaiming(shape, device, dtype, generator)
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.zeros((out_channels,), device=device, dtype=dtype))

    def forward(self, x):
        return self._fn(x, self.weight, self.bias, stride=self.stride,
                        padding=self.padding, dilation=self.dilation,
                        groups=self.groups, data_format=self.data_format)

    def extra_repr(self):
        return (f"{self.in_channels}, {self.out_channels}, "
                f"kernel_size={self.kernel_size}, stride={self.stride}, "
                f"padding={self.padding}")


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 bias_attr=None, data_format="NCHW", device=None,
                 dtype=torch.float32, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, padding_mode, bias_attr,
                         data_format, device, dtype, generator, F.conv2d)


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 bias_attr=None, data_format="NCL", device=None,
                 dtype=torch.float32, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, padding_mode, bias_attr,
                         data_format, device, dtype, generator, F.conv1d)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 bias_attr=None, data_format="NCDHW", device=None,
                 dtype=torch.float32, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, padding_mode, bias_attr,
                         data_format, device, dtype, generator, F.conv3d)


class Conv2DTranspose(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 bias_attr=None, data_format="NCHW", device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        if data_format != "NCHW":
            raise ValueError(f"Conv2DTranspose: data_format={data_format!r}"
                             " is not supported (the reference's layer "
                             "runs NCHW)")
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.output_padding = output_padding
        shape = (in_channels, out_channels // groups) + _ntuple(kernel_size,
                                                                2)
        self.weight = _kaiming(shape, device, dtype, generator)
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.zeros((out_channels,), device=device, dtype=dtype))

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(
            x, self.weight, self.bias, stride=self.stride,
            padding=self.padding, output_padding=self.output_padding,
            dilation=self.dilation, groups=self.groups,
            output_size=output_size)
