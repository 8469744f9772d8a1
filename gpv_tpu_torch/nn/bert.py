"""BERT-base query encoder, frozen (counterpart of `gpv_tpu/nn/bert.py`).

Reference `exp/gpv/models/bert.py`: HF `bert-base-uncased` last hidden
states, run under `no_grad` and detached (`gpv.py:142-145`). Built here
from torch modules rather than on HF `BertModel`, so that its attention
goes through the fused kernel K1: 12 post-norm layers, 12 heads, GELU-erf
FFN 3072, LayerNorm eps 1e-12, learned position and token-type embeddings,
pad keys masked. Parameter names follow HF (`model.embeddings.*`,
`model.encoder.layer.{i}.attention.self.query`, ...), so the reference's
`bert.model.*` weights load as they are.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import attend_heads

LN_EPS = 1e-12


class BertEmbeddings(nn.Module):
    def __init__(self, vocab_size: int, hidden: int, max_len: int,
                 type_vocab: int = 2):
        super().__init__()
        self.word_embeddings = nn.Embedding(vocab_size, hidden)
        self.position_embeddings = nn.Embedding(max_len, hidden)
        self.token_type_embeddings = nn.Embedding(type_vocab, hidden)
        self.LayerNorm = nn.LayerNorm(hidden, eps=LN_EPS)

    def forward(self, input_ids, token_type_ids=None):
        T = input_ids.shape[1]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        pos = torch.arange(T, device=input_ids.device)[None]
        x = (self.word_embeddings(input_ids) + self.position_embeddings(pos)
             + self.token_type_embeddings(token_type_ids))
        return self.LayerNorm(x)


class BertSelfAttention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)

    def forward(self, x, valid=None):
        split = lambda y: y.view(*y.shape[:-1], self.heads, -1)  # noqa: E731
        return attend_heads(split(self.query(x)), split(self.key(x)),
                            split(self.value(x)), valid)


class _DenseNorm(nn.Module):
    """HF's `*Output`: dense, residual, LayerNorm."""

    def __init__(self, d_in: int, hidden: int):
        super().__init__()
        self.dense = nn.Linear(d_in, hidden)
        self.LayerNorm = nn.LayerNorm(hidden, eps=LN_EPS)

    def forward(self, h, residual):
        return self.LayerNorm(residual + self.dense(h))


class _Attention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.self = BertSelfAttention(hidden, heads)
        self.output = _DenseNorm(hidden, hidden)


class _Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)


class BertLayer(nn.Module):
    def __init__(self, hidden: int = 768, heads: int = 12,
                 intermediate: int = 3072):
        super().__init__()
        self.attention = _Attention(hidden, heads)
        self.intermediate = _Dense(hidden, intermediate)
        self.output = _DenseNorm(intermediate, hidden)

    def forward(self, x, valid=None):
        x = self.attention.output(self.attention.self(x, valid), x)
        h = F.gelu(self.intermediate.dense(x))  # erf form
        return self.output(h, x)


class BertModel(nn.Module):
    def __init__(self, num_layers: int, hidden: int, heads: int,
                 intermediate: int, vocab_size: int, max_len: int):
        super().__init__()
        self.embeddings = BertEmbeddings(vocab_size, hidden, max_len)
        self.encoder = nn.Module()
        self.encoder.layer = nn.ModuleList(
            BertLayer(hidden, heads, intermediate)
            for _ in range(num_layers))


class BertEncoder(nn.Module):
    """BERT-base; (B, T) ids -> last hidden states (B, T, hidden).
    The HF model sits in `model`, as in the reference's `Bert` wrapper."""

    def __init__(self, num_layers: int = 12, hidden: int = 768,
                 heads: int = 12, intermediate: int = 3072,
                 vocab_size: int = 30522, max_len: int = 512):
        super().__init__()
        self.model = BertModel(num_layers, hidden, heads, intermediate,
                               vocab_size, max_len)

    def forward(self, input_ids, valid: Optional[torch.Tensor] = None,
                token_type_ids=None):
        x = self.model.embeddings(input_ids, token_type_ids)
        for layer in self.model.encoder.layer:
            x = layer(x, valid)
        return x
