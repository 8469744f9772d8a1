"""DETR encoder-decoder transformer (counterpart of
`gpv_tpu/nn/detr_transformer.py`).

Reference `exp/gpv/models/transformer.py`: 6+6 layers, d=256, 8 heads,
FFN 2048, ReLU, position embeddings added to Q/K (not V) at every layer,
the decoder runs the learned queries from a zero target, LayerNorm eps
1e-5, post-norm by default and `pre_norm` with a final encoder LayerNorm.
Parameter names follow the reference (`encoder.layers.{i}.self_attn`,
`decoder.layers.{i}.multihead_attn`, `decoder.norm`). Batch-first
(B, T, D). Dropout (rate `dropout`, on the attention probabilities and
after each sublayer, as the JAX layers place it) acts only when a forward
is not `deterministic`; so does the training attention route.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import MultiHeadAttention, dropout


class EncoderLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, ffn_dim: int,
                 pre_norm: bool = False, dropout: float = 0.0):
        super().__init__()
        self.pre_norm, self.dropout = pre_norm, dropout
        self.self_attn = MultiHeadAttention(dim, num_heads, dropout)
        self.linear1 = nn.Linear(dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, dim)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)

    def forward(self, src, pos, key_valid=None, deterministic: bool = True):
        def drop(x):
            return dropout(x, self.dropout, deterministic)

        def ffn(x):
            return drop(self.linear2(drop(F.relu(self.linear1(x)))))

        if self.pre_norm:
            x = self.norm1(src)
            q = x + pos
            src = src + drop(self.self_attn(q, q, x, key_valid,
                                            deterministic=deterministic))
            return src + ffn(self.norm2(src))
        q = src + pos
        src = self.norm1(src + drop(self.self_attn(
            q, q, src, key_valid, deterministic=deterministic)))
        return self.norm2(src + ffn(src))


class DecoderLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, ffn_dim: int,
                 pre_norm: bool = False, dropout: float = 0.0):
        super().__init__()
        self.pre_norm, self.dropout = pre_norm, dropout
        self.self_attn = MultiHeadAttention(dim, num_heads, dropout)
        self.multihead_attn = MultiHeadAttention(dim, num_heads, dropout)
        self.linear1 = nn.Linear(dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, dim)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.norm3 = nn.LayerNorm(dim)

    def forward(self, tgt, memory, query_pos, mem_pos, mem_valid=None,
                deterministic: bool = True):
        def drop(x):
            return dropout(x, self.dropout, deterministic)

        def ffn(x):
            return drop(self.linear2(drop(F.relu(self.linear1(x)))))

        if self.pre_norm:
            x = self.norm1(tgt)
            q = x + query_pos
            tgt = tgt + drop(self.self_attn(q, q, x,
                                            deterministic=deterministic))
            x = self.norm2(tgt)
            tgt = tgt + drop(self.multihead_attn(
                x + query_pos, memory + mem_pos, memory, mem_valid,
                deterministic=deterministic))
            return tgt + ffn(self.norm3(tgt))
        q = tgt + query_pos
        tgt = self.norm1(tgt + drop(self.self_attn(
            q, q, tgt, deterministic=deterministic)))
        ca = self.multihead_attn(tgt + query_pos, memory + mem_pos, memory,
                                 mem_valid, deterministic=deterministic)
        tgt = self.norm2(tgt + drop(ca))
        return self.norm3(tgt + ffn(tgt))


class _Stack(nn.Module):
    """`layers` plus an optional final `norm` (reference naming)."""

    def __init__(self, layers, norm=None):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.norm = norm


class DetrTransformer(nn.Module):
    """(B, HW, D) features -> normed query states: (B, Q, D) of the last
    decoder layer, or (L, B, Q, D) of every layer with
    `return_intermediate` (the aux losses' inputs)."""

    def __init__(self, dim: int = 256, num_heads: int = 8,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 ffn_dim: int = 2048, pre_norm: bool = False,
                 dropout: float = 0.0):
        super().__init__()
        self.encoder = _Stack(
            [EncoderLayer(dim, num_heads, ffn_dim, pre_norm, dropout)
             for _ in range(num_encoder_layers)],
            nn.LayerNorm(dim) if pre_norm else None)
        self.decoder = _Stack(
            [DecoderLayer(dim, num_heads, ffn_dim, pre_norm, dropout)
             for _ in range(num_decoder_layers)], nn.LayerNorm(dim))

    def forward(self, src, pos, query_embed, key_valid=None,
                deterministic: bool = True,
                return_intermediate: bool = False):
        """src/pos: (B, HW, D); query_embed: (Q, D); key_valid: (B, HW)."""
        memory = src
        for layer in self.encoder.layers:
            memory = layer(memory, pos, key_valid, deterministic)
        if self.encoder.norm is not None:
            memory = self.encoder.norm(memory)
        query_pos = query_embed[None].expand(src.shape[0], -1, -1)
        tgt = torch.zeros_like(query_pos)
        states = []
        for layer in self.decoder.layers:
            tgt = layer(tgt, memory, query_pos, pos, key_valid,
                        deterministic)
            if return_intermediate:
                states.append(self.decoder.norm(tgt))
        if return_intermediate:
            return torch.stack(states), memory
        return self.decoder.norm(tgt), memory
