"""Space-to-depth stem rewrite, exact (counterpart of
`gpv_tpu/ops/stem_s2d.py`).

The ResNet stem conv (7x7, stride 2, 3 input channels) is rewritten as

  conv7x7/s2/pad3 over (3, H, W)
    == conv4x4/s1/pad(2,1) over space_to_depth_2x2(x): (12, H/2, W/2)

with the 7x7 kernel zero-padded to 8x8 (one leading zero tap per axis: pad
3 puts the receptive field at offset -3, and the 2x2 blocks align at even
offsets -4..3) and rearranged into a (O, 12, 4, 4) kernel. The same
multiply-adds plus zero taps, so outputs match to float reassociation;
checkpoints carry over by transforming the weights. Output position o
reads input rows 2o-3..2o+3, which lie in the 2-blocks o-2..o+1 (4 taps:
padding 2 before and 1 after); blocked tap t holds kernel row
ky = 2t + dy - 1 for the in-block offset dy (ky = -1 is the zero tap).

Layout: NCHW, as the port's ResNet runs (on channels-last memory); the
blocked channel index is (dy*2 + dx)*C + c, the JAX package's. torch's
`padding` is symmetric, so the stem pads with `F.pad(x, (2, 1, 2, 1))` and
convolves with padding 0 (`nn.resnet.ResNet`).

Composes with `ops.fold_bn` in either order: folding scales the kernel per
output channel, this transform only moves kernel entries.
"""
from __future__ import annotations

from typing import Dict

import torch

STEM_PAD = (2, 1, 2, 1)  # F.pad order: W before, W after, H before, H after


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, 4C, H/2, W/2), channel (dy*2 + dx)*C + c, on
    channels-last memory. H and W must be even."""
    B, C, H, W = x.shape
    if H % 2 or W % 2:
        raise ValueError(
            f"space_to_depth needs even spatial dims, got {H}x{W}")
    y = x.permute(0, 2, 3, 1).reshape(B, H // 2, 2, W // 2, 2, C)
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(B, H // 2, W // 2, 4 * C)
    return y.permute(0, 3, 1, 2)


def s2d_stem_kernel(weight: torch.Tensor) -> torch.Tensor:
    """Rewrite an OIHW (O, C, 7, 7) stride-2 stem kernel as the equivalent
    (O, 4C, 4, 4) stride-1 kernel over `space_to_depth` input."""
    w = torch.as_tensor(weight)
    O, C, kh, kw = w.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"expected a 7x7 stem kernel, got {kh}x{kw}")
    out = w.new_zeros(O, 4 * C, 4, 4)
    for ty in range(4):
        for dy in range(2):
            ky = 2 * ty + dy - 1
            if not 0 <= ky <= 6:
                continue
            for tx in range(4):
                for dx in range(2):
                    kx = 2 * tx + dx - 1
                    if not 0 <= kx <= 6:
                        continue
                    blk = (dy * 2 + dx) * C
                    out[:, blk:blk + C, ty, tx] = w[:, :, ky, kx]
    return out


def apply_stem_s2d(state_dict: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """A copy of a reference-named state dict (GPV, DETR or ResNet) with
    every stem `conv1.weight` of shape (O, C, 7, 7) rewritten for the s2d
    stem (`detr.backbone.0.body.conv1.weight` in a GPV); the bottlenecks'
    1x1 `conv1` kernels are left alone. Pair with a model built with
    `model.detr.stem_s2d`."""
    out, hits = dict(state_dict), []
    for name, w in state_dict.items():
        if (name.rpartition(".")[0].rpartition(".")[2] == "conv1"
                and name.endswith(".weight") and w.dim() == 4
                and tuple(w.shape[2:]) == (7, 7)):
            out[name] = s2d_stem_kernel(w)
            hits.append(name)
    if not hits:
        raise ValueError("apply_stem_s2d: no 7x7 conv1 stem kernel found "
                         "(already transformed, or not a ResNet tree?)")
    return out
