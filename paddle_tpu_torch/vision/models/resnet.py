"""The ResNet family, after ``paddle_tpu/vision/models/resnet.py`` (config
1's model): the same blocks, names and parameter layouts, so a
``paddle_tpu`` ResNet's state dict (parameters and the batch norms'
``_mean`` / ``_variance``) loads with no renames (``convert.
resnet_from_numpy``).

``ResNet`` builds on ``device`` (the card unless the caller asks for the
CPU) and draws its weights from ``generator`` (the next one of
``framework.random.next_generator`` when None): convolutions
KaimingNormal, the classifier XavierNormal, batch norms ones and zeros.
There are no pretrained weights: ``pretrained=True`` raises, as in the
reference.
"""
from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn
from ...framework import random as _random
from ...framework.device import resolve_device

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152",
           "wide_resnet50_2", "wide_resnet101_2"]


class BasicBlock(tnn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, **kw):
        super().__init__()
        norm_layer = norm_layer or nn.BatchNorm2D
        dd = {k: kw[k] for k in ("device", "dtype") if k in kw}
        self.conv1 = nn.Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                               bias_attr=False, **kw)
        self.bn1 = norm_layer(planes, **dd)
        self.relu = nn.ReLU()
        self.conv2 = nn.Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                               **kw)
        self.bn2 = norm_layer(planes, **dd)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(tnn.Module):
    """1x1 → 3x3 (the stride, on ``conv2``) → 1x1, four times wider out."""

    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, **kw):
        super().__init__()
        norm_layer = norm_layer or nn.BatchNorm2D
        dd = {k: kw[k] for k in ("device", "dtype") if k in kw}
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = nn.Conv2D(inplanes, width, 1, bias_attr=False, **kw)
        self.bn1 = norm_layer(width, **dd)
        self.conv2 = nn.Conv2D(width, width, 3, stride=stride,
                               padding=dilation, groups=groups,
                               dilation=dilation, bias_attr=False, **kw)
        self.bn2 = norm_layer(width, **dd)
        self.conv3 = nn.Conv2D(width, planes * self.expansion, 1,
                               bias_attr=False, **kw)
        self.bn3 = norm_layer(planes * self.expansion, **dd)
        self.relu = nn.ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(tnn.Module):
    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        layer_cfg = {
            18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
            101: [3, 4, 23, 3], 152: [3, 8, 36, 3],
        }
        layers = layer_cfg[depth]
        dev = resolve_device(device)
        gen = generator or _random.next_generator(dev)
        self._kw = dict(device=dev, dtype=dtype, generator=gen)
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.inplanes = 64
        self.dilation = 1

        self.conv1 = nn.Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                               bias_attr=False, **self._kw)
        self.bn1 = nn.BatchNorm2D(self.inplanes, device=dev, dtype=dtype)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(kernel_size=3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes,
                                **self._kw)
        del self._kw

    def _make_layer(self, block, planes, blocks, stride=1):
        kw = self._kw
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2D(self.inplanes, planes * block.expansion, 1,
                          stride=stride, bias_attr=False, **kw),
                nn.BatchNorm2D(planes * block.expansion,
                               device=kw["device"], dtype=kw["dtype"]),
            )
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, **kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width, **kw))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.fc(x)
        return x


def _resnet(block, depth, pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError("pretrained weights require network "
                                  "access; load a checkpoint instead")
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, width=128, **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, width=128, **kwargs)
