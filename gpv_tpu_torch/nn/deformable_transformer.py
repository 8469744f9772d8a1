"""Deformable DETR's encoder-decoder transformer (Zhu et al., "Deformable
DETR", ICLR 2021; fundamentalvision/Deformable-DETR
`models/deformable_transformer.py`), the plain variant: no box
refinement, no two stages.

Every encoder layer's self-attention and every decoder layer's cross
attention is multi-scale deformable attention (`MSDeformAttn`): per head,
L x P samples of the value around each query's reference point on every
level, weighted by a softmax over the L*P logits; offsets and logits are
linear maps of the query, the value a linear map of the input
(`ops.ms_deform_attn`: the CUDA kernel on the card; a forward that is not
`deterministic`, training's, calls the differentiable
`ms_deform_attn_plain`, as attention calls `attend_train`). The
decoder's self-attention stays a `MultiHeadAttention` (K1 on the card).

- Input: the levels' (B, D, h_l, w_l) maps, flattened level after level
  into S = sum_l h_l w_l rows; each level's sine position embedding plus
  its learned `level_embed` row.
- Valid ratios: each image's share of valid columns and rows on every
  level (`valid_ratios`, from the first row and column of its mask);
  padded value rows are zeroed before sampling.
- Encoder reference points: every pixel centre of every level,
  normalised by the valid extent, then scaled into every level by the
  ratios (`encoder_reference_points`).
- Decoder: the learned query embedding (Q, 2D) splits into the query
  position and the initial target; reference points are
  sigmoid(`reference_points`(position)), computed in fp32, scaled by the
  ratios into every level.
- Layers are post-norm, FFN with ReLU. Encoder layer: norm1 after the
  deformable self-attention, norm2 after the FFN. Decoder layer: norm2
  after the self-attention, norm1 after the deformable cross-attention,
  norm3 after the FFN (the published names). No final decoder norm.

Parameter names follow the published state dict (`level_embed`,
`reference_points`, `encoder.layers.{i}.self_attn.{sampling_offsets,
attention_weights,value_proj,output_proj}`, `decoder.layers.{i}.
cross_attn.*`, `decoder.layers.{i}.self_attn.in_proj_weight`, ...).
Dropout (after each sublayer, on the decoder's self-attention
probabilities) acts only when a forward is not `deterministic`. The
stages are the spans `encode.deform_encoder` and `encode.deform_decoder`
(`utils.profiling`). `remat` recomputes each layer in the backward.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.ms_deform_attn import ms_deform_attn, ms_deform_attn_plain
from ..utils.profiling import span
from .detr_transformer import _Stack, ffn
from .layers import MultiHeadAttention, dropout, remat


class MSDeformAttn(nn.Module):
    """Multi-scale deformable attention over (B, S, D) value rows."""

    def __init__(self, dim: int = 256, levels: int = 4, heads: int = 8,
                 points: int = 4):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} not divisible by {heads} heads")
        self.levels, self.heads, self.points = levels, heads, points
        self.sampling_offsets = nn.Linear(dim, heads * levels * points * 2)
        self.attention_weights = nn.Linear(dim, heads * levels * points)
        self.value_proj = nn.Linear(dim, dim)
        self.output_proj = nn.Linear(dim, dim)

    def forward(self, query, ref, value_in, shapes: Sequence[Tuple[int, int]],
                value_valid: Optional[torch.Tensor] = None,
                deterministic: bool = True):
        """query (B, Q, D), ref (B, Q, L, 2) fp32, value_in (B, S, D),
        value_valid (B, S) bool or None -> (B, Q, D). The sampling is the
        kernel's when `deterministic`, else the plain op's."""
        B, Q, D = query.shape
        H, L, P = self.heads, self.levels, self.points
        value = self.value_proj(value_in)
        if value_valid is not None:
            value = value.masked_fill(~value_valid[..., None], 0.0)
        value = value.view(B, value.shape[1], H, D // H)
        off = self.sampling_offsets(query).view(B, Q, H, L, P, 2)
        logits = self.attention_weights(query).view(B, Q, H, L * P)
        sample = ms_deform_attn if deterministic else ms_deform_attn_plain
        out = sample(value, shapes, ref.contiguous(), off, logits)
        return self.output_proj(out)


class DeformableEncoderLayer(nn.Module):
    def __init__(self, dim: int, heads: int, ffn_dim: int, levels: int,
                 points: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MSDeformAttn(dim, levels, heads, points)
        self.norm1 = nn.LayerNorm(dim)
        self.linear1 = nn.Linear(dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, dim)
        self.norm2 = nn.LayerNorm(dim)
        self.ffn_tp = None  # `detr_transformer.ffn` reads it

    def forward(self, src, pos, ref, shapes, valid=None,
                deterministic: bool = True):
        a = self.self_attn(src + pos, ref, src, shapes, valid, deterministic)
        src = self.norm1(src + dropout(a, self.dropout, deterministic))
        return self.norm2(src + ffn(self, src, deterministic))


class DeformableDecoderLayer(nn.Module):
    def __init__(self, dim: int, heads: int, ffn_dim: int, levels: int,
                 points: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.cross_attn = MSDeformAttn(dim, levels, heads, points)
        self.norm1 = nn.LayerNorm(dim)
        self.self_attn = MultiHeadAttention(dim, heads, dropout)
        self.norm2 = nn.LayerNorm(dim)
        self.linear1 = nn.Linear(dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, dim)
        self.norm3 = nn.LayerNorm(dim)
        self.ffn_tp = None

    def forward(self, tgt, query_pos, ref, memory, shapes, mem_valid=None,
                deterministic: bool = True):
        def drop(x):
            return dropout(x, self.dropout, deterministic)

        q = tgt + query_pos
        tgt = self.norm2(tgt + drop(self.self_attn(
            q, q, tgt, deterministic=deterministic)))
        ca = self.cross_attn(tgt + query_pos, ref, memory, shapes, mem_valid,
                             deterministic)
        tgt = self.norm1(tgt + drop(ca))
        return self.norm3(tgt + ffn(self, tgt, deterministic))


def valid_ratios(valid: torch.Tensor) -> torch.Tensor:
    """(B, h, w) bool (True = valid) -> (B, 2) fp32: the valid share of
    the columns (its first row's) and of the rows (its first column's)."""
    h, w = valid.shape[1:]
    rows = valid[:, :, 0].sum(1).float() / h
    cols = valid[:, 0, :].sum(1).float() / w
    return torch.stack([cols, rows], -1)


def encoder_reference_points(shapes: Sequence[Tuple[int, int]],
                             ratios: torch.Tensor) -> torch.Tensor:
    """(B, S, L, 2) fp32: every level's pixel centres, (x, y) over the
    valid extent of their level, scaled into each level by `ratios`
    (B, L, 2)."""
    dev, refs = ratios.device, []
    for lvl, (h, w) in enumerate(shapes):
        ys, xs = torch.meshgrid(
            torch.linspace(0.5, h - 0.5, h, dtype=torch.float32, device=dev),
            torch.linspace(0.5, w - 0.5, w, dtype=torch.float32, device=dev),
            indexing="ij")
        ys = ys.reshape(-1)[None] / (ratios[:, None, lvl, 1] * h)
        xs = xs.reshape(-1)[None] / (ratios[:, None, lvl, 0] * w)
        refs.append(torch.stack((xs, ys), -1))
    return torch.cat(refs, 1)[:, :, None] * ratios[:, None]


class DeformableTransformer(nn.Module):
    """Levels -> (query states (B, Q, D) of the last decoder layer, the
    decoder's reference points (B, Q, 2) fp32)."""

    def __init__(self, dim: int = 256, heads: int = 8,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 ffn_dim: int = 1024, levels: int = 4, enc_points: int = 4,
                 dec_points: int = 4, dropout: float = 0.0,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        self.level_embed = nn.Parameter(torch.zeros(levels, dim))
        self.encoder = _Stack(
            DeformableEncoderLayer(dim, heads, ffn_dim, levels, enc_points,
                                   dropout)
            for _ in range(num_encoder_layers))
        self.decoder = _Stack(
            DeformableDecoderLayer(dim, heads, ffn_dim, levels, dec_points,
                                   dropout)
            for _ in range(num_decoder_layers))
        self.reference_points = nn.Linear(dim, 2)

    def forward(self, srcs: List[torch.Tensor], pos: List[torch.Tensor],
                query_embed: torch.Tensor,
                valids: Optional[List[torch.Tensor]] = None,
                deterministic: bool = True):
        """srcs: the levels' (B, D, h, w) maps; pos: their (B, h, w, D)
        position embeddings; query_embed (Q, 2D); valids: the levels'
        (B, h, w) masks, or None when every image fills the batch."""
        def run(layer, *args):
            if self.remat and torch.is_grad_enabled():
                return remat(layer, *args)
            return layer(*args)

        B, D = srcs[0].shape[:2]
        dtype = srcs[0].dtype
        shapes = [tuple(int(x) for x in s.shape[-2:]) for s in srcs]
        src = torch.cat([s.flatten(2).transpose(1, 2) for s in srcs], 1)
        lvl_pos = torch.cat([p.reshape(B, -1, D).to(dtype)
                             + self.level_embed[lvl].to(dtype)
                             for lvl, p in enumerate(pos)], 1)
        if valids is None:
            valid = None
            ratios = torch.ones(B, len(srcs), 2, device=src.device)
        else:
            valid = torch.cat([v.flatten(1) for v in valids], 1)
            ratios = torch.stack([valid_ratios(v) for v in valids], 1)
        with span("encode.deform_encoder"):
            ref = encoder_reference_points(shapes, ratios)
            memory = src
            for layer in self.encoder.layers:
                memory = run(layer, memory, lvl_pos, ref, shapes, valid,
                             deterministic)
        with span("encode.deform_decoder"):
            query_pos, tgt = query_embed.split(D, dim=1)
            query_pos = query_pos[None].expand(B, -1, -1)
            tgt = tgt[None].expand(B, -1, -1)
            lin = self.reference_points
            with torch.autocast(src.device.type, enabled=False):
                ref_q = F.linear(query_pos.float(), lin.weight.float(),
                                 lin.bias.float()).sigmoid()
            ref_in = (ref_q[:, :, None] * ratios[:, None]).contiguous()
            for layer in self.decoder.layers:
                tgt = run(layer, tgt, query_pos, ref_in, memory, shapes,
                          valid, deterministic)
        return tgt, ref_q
