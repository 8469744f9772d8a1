"""Aligned RoI-align as separable interpolation weights (counterpart of
`gpv_tpu/ops/roi_align.py`): `roi_align_mean_pooled`, what the DETR RoI
head runs, and the full (B, N, 7, 7, C) `roi_align`.

Bilinear interpolation is separable and RoI-align's average pooling
commutes with it, so a mean-pooled RoI feature is
    out[b, n, c] = sum_{h, w} wy[b, n, h] * wx[b, n, w] * F[b, c, h, w]
with per-roi 1-D weight vectors over the feature grid: one `bmm` of
(N, H*W) x (H*W, C) per image, no gather. Semantics of
`torchvision.ops.roi_align(output_size=7, aligned=True, sampling_ratio=-1)`
then `.mean((-1, -2))`, except that the adaptive sampling grid is capped at
`max_grid` (8) samples per bin, as the JAX package does: that cap is the
reference behaviour here.
"""
from __future__ import annotations

import torch


def _bin_weights(start: torch.Tensor, extent: torch.Tensor, size: int,
                 pooled: int, max_grid: int) -> torch.Tensor:
    """Per-bin interpolation weights (..., pooled, size) for one axis,
    fp32: bin p of a RoI is sum_h w[..., p, h] * F[..., h]."""
    start, extent = start.float(), extent.float()
    dev = start.device
    bin_size = extent / pooled
    # torchvision: roi_bin_grid = ceil(roi_extent / pooled)
    grid = torch.ceil(extent / pooled).to(torch.int32).clamp(1, max_grid)
    p = torch.arange(pooled, dtype=torch.float32, device=dev)
    g = torch.arange(max_grid, dtype=torch.float32, device=dev)
    gridf = grid.float()[..., None, None]                     # (...,1,1)
    coord = (start[..., None, None]
             + p[:, None] * bin_size[..., None, None]
             + (g[None, :] + 0.5) * bin_size[..., None, None] / gridf)
    valid = (coord >= -1.0) & (coord <= size)  # outside -> 0
    sample_on = g[None, :] < gridf
    coord_c = coord.clamp(0.0, size - 1.0)
    hgrid = torch.arange(size, dtype=torch.float32, device=dev)
    k = (1.0 - (coord_c[..., None] - hgrid).abs()).clamp_min(0.0)
    k = k * (valid & sample_on)[..., None].float()            # (...,P,G,S)
    return k.sum(-2) / gridf                                  # (...,P,S)


def _axis_weights(start: torch.Tensor, extent: torch.Tensor, size: int,
                  pooled: int, max_grid: int) -> torch.Tensor:
    """Bin-mean interpolation weights (..., size) for one axis, fp32."""
    return _bin_weights(start, extent, size, pooled, max_grid).mean(-2)


def _scale_boxes(boxes_cxcywh: torch.Tensor, height: int, width: int):
    """Normalised cxcywh boxes -> aligned RoI starts and extents in
    feature coordinates: (y0, h, x0, w)."""
    cx, cy, w, h = boxes_cxcywh.unbind(-1)
    x0 = width * (cx - 0.5 * w) - 0.5  # aligned=True pixel-centre offset
    y0 = height * (cy - 0.5 * h) - 0.5
    return y0, height * h, x0, width * w


def roi_align_mean_pooled(features: torch.Tensor, boxes_cxcywh: torch.Tensor,
                          pooled: int = 7, max_grid: int = 8) -> torch.Tensor:
    """features: (B, C, H, W); boxes_cxcywh: (B, N, 4) normalised.
    Returns (B, N, C) fp32."""
    B, C, H, W = features.shape
    y0, hy, x0, wx_ = _scale_boxes(boxes_cxcywh, H, W)
    wy = _axis_weights(y0, hy, H, pooled, max_grid)           # (B,N,H)
    wx = _axis_weights(x0, wx_, W, pooled, max_grid)          # (B,N,W)
    whw = (wy[..., :, None] * wx[..., None, :]).flatten(2)    # (B,N,H*W)
    return torch.bmm(whw, features.float().flatten(2).transpose(1, 2))


def roi_align(features: torch.Tensor, boxes_cxcywh: torch.Tensor,
              pooled: int = 7, max_grid: int = 8) -> torch.Tensor:
    """Full aligned RoI-align in the JAX package's layout: features
    (B, H, W, C) channel-last, boxes_cxcywh (B, N, 4) normalised. Returns
    (B, N, pooled, pooled, C) fp32, the bins `roi_align_mean_pooled`
    averages: two contractions with the per-bin weights of each axis."""
    B, H, W, C = features.shape
    y0, hy, x0, wx_ = _scale_boxes(boxes_cxcywh, H, W)
    py = _bin_weights(y0, hy, H, pooled, max_grid)            # (B,N,P,H)
    px = _bin_weights(x0, wx_, W, pooled, max_grid)           # (B,N,P,W)
    t = torch.einsum("bnph,bhwc->bnpwc", py, features.float())
    return torch.einsum("bnpwc,bnqw->bnpqc", t, px)
