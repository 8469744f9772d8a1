"""Frozen-BatchNorm folding for serving (counterpart of
`gpv_tpu/ops/fold_bn.py`).

Each backbone conv is followed by a frozen affine BN:
`y = conv(x, W) * scale + shift`. The JAX package folds `scale` into the
conv kernel and keeps `shift` in an identity-scale BN. In torch it is
natural to go one step further and fold the shift into the conv's bias:
`y = conv(x, W * scale) + shift`, with the BN replaced by `nn.Identity`, so
cuDNN adds the shift inside the conv. Inference-only: the folded module has
other parameter names than the reference state dict.
"""
from __future__ import annotations

import torch
from torch import nn

from ..nn.layers import FrozenBatchNorm
from ..nn.resnet import Bottleneck, ResNet

_PAIRS = (("conv1", "bn1"), ("conv2", "bn2"), ("conv3", "bn3"))


@torch.no_grad()
def _fold(conv: nn.Conv2d, bn: FrozenBatchNorm) -> None:
    scale, shift = bn.scale_shift()
    conv.weight.mul_(scale[:, None, None, None])
    conv.bias = nn.Parameter(shift.clone(), requires_grad=False)


def fold_frozen_bn(resnet: ResNet) -> ResNet:
    """Fold every conv + FrozenBatchNorm pair of `resnet`, in place."""
    for module in [resnet, *resnet.modules()]:
        if not isinstance(module, (ResNet, Bottleneck)):
            continue
        for conv_name, bn_name in _PAIRS:
            bn = getattr(module, bn_name, None)
            if isinstance(bn, FrozenBatchNorm):
                _fold(getattr(module, conv_name), bn)
                setattr(module, bn_name, nn.Identity())
        ds = getattr(module, "downsample", None)
        if ds is not None and isinstance(ds[1], FrozenBatchNorm):
            _fold(ds[0], ds[1])
            ds[1] = nn.Identity()
    return resnet
