"""Positional encodings (counterpart of `gpv_tpu/ops/posenc.py`).

Reference `exp/gpv/models/position_encoding.py` (2-D sine: cumsum of the
valid mask normalised to 2*pi, temperature 10000, d/2 features per axis,
y-features then x-features) and the 1-D sine table `positionalencoding1d`
(`exp/gpv/models/gpv.py:18`). Computed in fp32, channel-last (B, H, W, C)
as in the JAX package; callers flatten to sequence form. The learned 2-D
variant (`position_embedding: learned` / `v3`, reference
`PositionEmbeddingLearned`, position_encoding.py:51-76) is a module with
50-entry row and column tables.
"""
from __future__ import annotations

import math

import torch
from torch import nn


def _interleave(pos: torch.Tensor) -> torch.Tensor:
    """[sin(p0), cos(p1), sin(p2), cos(p3), ...] over the last axis."""
    return torch.stack([pos[..., 0::2].sin(), pos[..., 1::2].cos()],
                       dim=-1).flatten(-2)


def sine_position_embedding_2d(valid_mask: torch.Tensor,
                               num_pos_feats: int = 128,
                               temperature: float = 10000.0,
                               normalize: bool = True,
                               scale: float | None = None) -> torch.Tensor:
    """valid_mask: (B, H, W) bool, True on VALID pixels.
    Returns (B, H, W, 2 * num_pos_feats) fp32, [y-features, x-features]."""
    if scale is None:
        scale = 2.0 * math.pi
    not_mask = valid_mask.float()
    y_embed = not_mask.cumsum(1)
    x_embed = not_mask.cumsum(2)
    if normalize:
        eps = 1e-6
        y_embed = y_embed / (y_embed[:, -1:, :] + eps) * scale
        x_embed = x_embed / (x_embed[:, :, -1:] + eps) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32,
                         device=valid_mask.device)
    dim_t = temperature ** (2.0 * torch.floor(dim_t / 2.0) / num_pos_feats)
    pos_x = _interleave(x_embed[..., None] / dim_t)
    pos_y = _interleave(y_embed[..., None] / dim_t)
    return torch.cat([pos_y, pos_x], dim=-1)


class LearnedPositionEmbedding2D(nn.Module):
    """Learned absolute 2-D position embedding: per pixel
    [col(x) features, row(y) features] (x first, unlike the sine
    variant), the same for every image; the validity mask is ignored, as
    in the reference. Tables `row_embed`, `col_embed` (table_size, F)."""

    def __init__(self, num_pos_feats: int = 128, table_size: int = 50):
        super().__init__()
        self.table_size = table_size
        self.row_embed = nn.Embedding(table_size, num_pos_feats)
        self.col_embed = nn.Embedding(table_size, num_pos_feats)

    def forward(self, batch: int, h: int, w: int) -> torch.Tensor:
        """-> (batch, h, w, 2F) in the tables' dtype."""
        if h > self.table_size or w > self.table_size:
            raise ValueError(
                f"learned position embedding table ({self.table_size}) too "
                f"small for a {h}x{w} feature map")
        F_ = self.row_embed.weight.shape[1]
        x_emb = self.col_embed.weight[None, :w].expand(h, w, F_)
        y_emb = self.row_embed.weight[:h, None].expand(h, w, F_)
        pos = torch.cat([x_emb, y_emb], dim=-1)
        return pos[None].expand(batch, h, w, 2 * F_)


def sine_position_encoding_1d(d_model: int, length: int) -> torch.Tensor:
    """1-D sine table, (length, d_model): even dims sin, odd dims cos."""
    if d_model % 2 != 0:
        raise ValueError(f"d_model must be even, got {d_model}")
    position = torch.arange(length, dtype=torch.float32)[:, None]
    div_term = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32)
                         * -(math.log(10000.0) / d_model))
    ang = position * div_term
    pe = torch.zeros(length, d_model)
    pe[:, 0::2] = ang.sin()
    pe[:, 1::2] = ang.cos()
    return pe
