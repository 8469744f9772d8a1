"""ResNet trunk with frozen BatchNorm, NCHW (counterpart of
`gpv_tpu/nn/resnet.py`).

Torchvision's layout and parameter names (`conv1`, `bn1`, `layer{s}.{b}`,
`downsample.{0,1}`), so a reference `backbone.0.body.*` state dict loads as
it is. Bottleneck: conv1x1 -> BN -> ReLU -> conv3x3(stride) -> BN -> ReLU ->
conv1x1 -> BN; add identity/downsample; ReLU. The stride sits on the 3x3
conv (torchvision v1.5 "ResNet B"). Returns C5 (2048 channels, stride 32).
"""
from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn

from .layers import FrozenBatchNorm


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 downsample: bool = False, dilation: int = 1):
        super().__init__()
        out_ch = planes * 4
        self.conv1 = nn.Conv2d(in_ch, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride,
                               padding=dilation, dilation=dilation,
                               bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = nn.Conv2d(planes, out_ch, 1, bias=False)
        self.bn3 = FrozenBatchNorm(out_ch)
        self.downsample = (nn.Sequential(
            nn.Conv2d(in_ch, out_ch, 1, stride=stride, bias=False),
            FrozenBatchNorm(out_ch)) if downsample else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + identity)


class ResNet(nn.Module):
    """ResNet-50/101 trunk: (B, 3, H, W) -> C5 (B, 2048, H/32, W/32)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 dilate_c5: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        in_ch = 64
        for i, (n_blocks, planes) in enumerate(zip(layers,
                                                   (64, 128, 256, 512))):
            stride, dilation = (1 if i == 0 else 2), 1
            if dilate_c5 and i == 3:
                stride, dilation = 1, 2
            blocks = [Bottleneck(in_ch if b == 0 else planes * 4, planes,
                                 stride if b == 0 else 1, downsample=b == 0,
                                 dilation=dilation)
                      for b in range(n_blocks)]
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
            in_ch = planes * 4

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for i in range(4):
            x = getattr(self, f"layer{i + 1}")(x)
        return x
