"""DETR encoder-decoder transformer (counterpart of
`gpv_tpu/nn/detr_transformer.py`).

Reference `exp/gpv/models/transformer.py`: 6+6 layers, d=256, 8 heads,
FFN 2048, ReLU, position embeddings added to Q/K (not V) at every layer,
the decoder runs the learned queries from a zero target, LayerNorm eps
1e-5, post-norm by default and `pre_norm` with a final encoder LayerNorm.
Parameter names follow the reference (`encoder.layers.{i}.self_attn`,
`decoder.layers.{i}.multihead_attn`, `decoder.norm`). Batch-first
(B, T, D). Inference keeps only the last decoder layer's normed output
(`last_layer_only`, no aux loss).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import MultiHeadAttention


class EncoderLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, ffn_dim: int,
                 pre_norm: bool = False):
        super().__init__()
        self.pre_norm = pre_norm
        self.self_attn = MultiHeadAttention(dim, num_heads)
        self.linear1 = nn.Linear(dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, dim)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)

    def forward(self, src, pos, key_valid=None):
        if self.pre_norm:
            x = self.norm1(src)
            q = x + pos
            src = src + self.self_attn(q, q, x, key_valid)
            x = self.norm2(src)
            return src + self.linear2(F.relu(self.linear1(x)))
        q = src + pos
        src = self.norm1(src + self.self_attn(q, q, src, key_valid))
        return self.norm2(src + self.linear2(F.relu(self.linear1(src))))


class DecoderLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, ffn_dim: int,
                 pre_norm: bool = False):
        super().__init__()
        self.pre_norm = pre_norm
        self.self_attn = MultiHeadAttention(dim, num_heads)
        self.multihead_attn = MultiHeadAttention(dim, num_heads)
        self.linear1 = nn.Linear(dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, dim)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.norm3 = nn.LayerNorm(dim)

    def forward(self, tgt, memory, query_pos, mem_pos, mem_valid=None):
        if self.pre_norm:
            x = self.norm1(tgt)
            q = x + query_pos
            tgt = tgt + self.self_attn(q, q, x)
            x = self.norm2(tgt)
            tgt = tgt + self.multihead_attn(x + query_pos, memory + mem_pos,
                                            memory, mem_valid)
            x = self.norm3(tgt)
            return tgt + self.linear2(F.relu(self.linear1(x)))
        q = tgt + query_pos
        tgt = self.norm1(tgt + self.self_attn(q, q, tgt))
        ca = self.multihead_attn(tgt + query_pos, memory + mem_pos, memory,
                                 mem_valid)
        tgt = self.norm2(tgt + ca)
        return self.norm3(tgt + self.linear2(F.relu(self.linear1(tgt))))


class _Stack(nn.Module):
    """`layers` plus an optional final `norm` (reference naming)."""

    def __init__(self, layers, norm=None):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.norm = norm


class DetrTransformer(nn.Module):
    """(B, HW, D) features -> (B, Q, D) normed last-layer query states."""

    def __init__(self, dim: int = 256, num_heads: int = 8,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 ffn_dim: int = 2048, pre_norm: bool = False):
        super().__init__()
        self.encoder = _Stack(
            [EncoderLayer(dim, num_heads, ffn_dim, pre_norm)
             for _ in range(num_encoder_layers)],
            nn.LayerNorm(dim) if pre_norm else None)
        self.decoder = _Stack(
            [DecoderLayer(dim, num_heads, ffn_dim, pre_norm)
             for _ in range(num_decoder_layers)], nn.LayerNorm(dim))

    def forward(self, src, pos, query_embed, key_valid=None):
        """src/pos: (B, HW, D); query_embed: (Q, D); key_valid: (B, HW)."""
        memory = src
        for layer in self.encoder.layers:
            memory = layer(memory, pos, key_valid)
        if self.encoder.norm is not None:
            memory = self.encoder.norm(memory)
        query_pos = query_embed[None].expand(src.shape[0], -1, -1)
        tgt = torch.zeros_like(query_pos)
        for layer in self.decoder.layers:
            tgt = layer(tgt, memory, query_pos, pos, key_valid)
        return self.decoder.norm(tgt), memory
