"""Answer text decoder with KV-cached incremental decoding (counterpart of
`gpv_tpu/nn/text_decoder.py`).

Reference: torch `nn.TransformerDecoder(nn.TransformerDecoderLayer(
d_model=768, nhead=8), num_layers=3)` (`exp/gpv/models/gpv.py:37-43`):
post-norm, ReLU, FFN 2048, causal self-attention, no final norm. Names
follow it (`layers.{i}.self_attn`, `layers.{i}.multihead_attn`, ...).

The teacher-forced path is one call; the sampling path computes the
cross-attention K/V once (`precompute_memory`) and runs one token per
`step` against a static (B, S, H, Dh) self-attention cache, so the fused
kernel sees the same shapes at every step. The cache is written in place
at position t (no copy of the whole cache per step) and masked by
`arange(S) <= t`. Dropout (torch's `TransformerDecoderLayer` places, rate
`dropout`) acts only in a teacher-forced forward that is not
`deterministic`, which also takes the training attention route.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import MultiHeadAttention, dropout


class TextDecoderLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, ffn_dim: int = 2048,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadAttention(dim, num_heads, dropout)
        self.multihead_attn = MultiHeadAttention(dim, num_heads, dropout)
        self.linear1 = nn.Linear(dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, dim)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.norm3 = nn.LayerNorm(dim)

    def _ffn(self, x, deterministic: bool = True):
        def drop(y):
            return dropout(y, self.dropout, deterministic)
        return self.norm3(x + drop(self.linear2(drop(F.relu(
            self.linear1(x))))))

    def forward(self, tgt, memory, mem_valid=None,
                deterministic: bool = True):
        sa = self.self_attn(tgt, tgt, tgt, causal=True,
                            deterministic=deterministic)
        tgt = self.norm1(tgt + dropout(sa, self.dropout, deterministic))
        ca = self.multihead_attn(tgt, memory, memory, mem_valid,
                                 deterministic=deterministic)
        return self._ffn(self.norm2(tgt + dropout(ca, self.dropout,
                                                  deterministic)),
                         deterministic)

    def precompute_memory(self, memory):
        """Cross-attention K/V, once per decode: (B,Tm,H,Dh) x2."""
        return self.multihead_attn.project_kv(memory, memory)

    def step(self, x_t, mem_kv, mem_valid, cache_k, cache_v, t: int,
             pos_valid, beam_group: int = 1):
        """One token: x_t (B,1,D) at position t (an int, or a 0-d int64
        tensor when the step is traced for export, so one program serves
        every t); cache_k/v (B,S,H,Dh) are written at t in place;
        pos_valid (B,S) = arange(S) <= t.

        beam_group K > 1 marks x_t as B = B'·K sample-major beam rows whose
        mem_kv/mem_valid stay untiled at (B', ·): the K beams of a sample
        share the cross-attention K/V, so the beam axis rides the query
        axis of one (B', K) attention call instead of repeating the memory
        K-fold. Same result as passing the memory repeated.
        Returns y_t (B,1,D)."""
        qh = self.self_attn.project_q(x_t)
        kh_t, vh_t = self.self_attn.project_kv(x_t, x_t)
        if isinstance(t, torch.Tensor):  # an exported step's 0-d input
            cache_k.index_copy_(1, t.view(1), kh_t)
            cache_v.index_copy_(1, t.view(1), vh_t)
        else:
            cache_k[:, t] = kh_t[:, 0]
            cache_v[:, t] = vh_t[:, 0]
        x = self.norm1(x_t + self.self_attn.attend(qh, cache_k, cache_v,
                                                   pos_valid))
        mem_k, mem_v = mem_kv
        q = self.multihead_attn.project_q(x)  # (B,1,H,Dh), contiguous
        B = q.shape[0]
        if beam_group > 1:
            q = q.view(B // beam_group, beam_group, *q.shape[2:])
        ca = self.multihead_attn.attend(q, mem_k, mem_v, mem_valid)
        return self._ffn(self.norm2(x + ca.view(B, 1, -1)))


class TextDecoder(nn.Module):
    """Stack of TextDecoderLayers; torch TransformerDecoder semantics."""

    def __init__(self, dim: int = 768, num_heads: int = 8,
                 num_layers: int = 3, ffn_dim: int = 2048,
                 dropout: float = 0.0):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.layers = nn.ModuleList(
            TextDecoderLayer(dim, num_heads, ffn_dim, dropout)
            for _ in range(num_layers))

    def forward(self, tgt, memory, mem_valid=None,
                deterministic: bool = True):
        for layer in self.layers:
            tgt = layer(tgt, memory, mem_valid, deterministic)
        return tgt

    def precompute_memory(self, memory):
        return tuple(layer.precompute_memory(memory) for layer in self.layers)

    def init_cache(self, batch: int, max_len: int, dtype, device):
        shape = (batch, max_len, self.num_heads, self.dim // self.num_heads)
        return tuple((torch.zeros(shape, dtype=dtype, device=device),
                      torch.zeros(shape, dtype=dtype, device=device))
                     for _ in self.layers)

    def step(self, x_t, mem_kvs, mem_valid, caches, t: int,
             beam_group: int = 1):
        """One token through all layers; the caches are updated in place.
        `beam_group` as in `TextDecoderLayer.step`. Returns y_t (B,1,D)."""
        S = caches[0][0].shape[1]
        pos_valid = (torch.arange(S, device=x_t.device) <= t).expand(
            x_t.shape[0], S).contiguous()
        for layer, mem_kv, (ck, cv) in zip(self.layers, mem_kvs, caches):
            x_t = layer.step(x_t, mem_kv, mem_valid, ck, cv, t, pos_valid,
                             beam_group)
        return x_t
