"""Pooling layers, after ``paddle_tpu/nn/pooling.py``. Each passes its
arguments to the function of ``nn.functional.pooling``, which refuses
the ones the reference ignores unless they keep their defaults."""
from __future__ import annotations

from torch import nn

from . import functional as F

__all__ = ["MaxPool1D", "MaxPool2D", "AvgPool1D", "AvgPool2D",
           "AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveMaxPool2D"]


class MaxPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format="NCHW", name=None):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, \
            padding
        self.ceil_mode, self.return_mask = ceil_mode, return_mask
        self.data_format = data_format

    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode, self.return_mask,
                            self.data_format)


class AvgPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, \
            padding
        self.ceil_mode, self.data_format = ceil_mode, data_format
        self.exclusive, self.divisor_override = exclusive, divisor_override

    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode, self.exclusive,
                            self.divisor_override, self.data_format)


class MaxPool1D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, name=None):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, \
            padding
        self.ceil_mode, self.return_mask = ceil_mode, return_mask

    def forward(self, x):
        return F.max_pool1d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode, self.return_mask)


class AvgPool1D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, \
            padding
        self.exclusive, self.ceil_mode = exclusive, ceil_mode

    def forward(self, x):
        return F.avg_pool1d(x, self.kernel_size, self.stride, self.padding,
                            self.exclusive, self.ceil_mode)


class AdaptiveAvgPool2D(nn.Module):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size, self.data_format = output_size, data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, self.data_format)


class AdaptiveAvgPool1D(nn.Module):
    def __init__(self, output_size, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveMaxPool2D(nn.Module):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size, self.return_mask = output_size, return_mask

    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size, self.return_mask)
