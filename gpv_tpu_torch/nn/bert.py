"""BERT-base query encoder, frozen (counterpart of `gpv_tpu/nn/bert.py`).

Reference `exp/gpv/models/bert.py`: HF `bert-base-uncased` last hidden
states, run under `no_grad` and detached (`gpv.py:142-145`). Built here
from torch modules rather than on HF `BertModel`, so that its attention
goes through the fused kernel K1: 12 post-norm layers, 12 heads, GELU-erf
FFN 3072, LayerNorm eps 1e-12, learned position and token-type embeddings,
pad keys masked. Parameter names follow HF (`model.embeddings.*`,
`model.encoder.layer.{i}.attention.self.query`, ...), so the reference's
`bert.model.*` weights load as they are. Sharded
(`models.gpv.shard_params`), `attention.self.{query,key,value}` and
`intermediate.dense` are column-parallel (this rank's heads and FFN
columns) and `attention.output.dense` and `output.dense` row-parallel
(`parallel.tensor_parallel`); BERT runs without a gradient, so only the
forward's all-reduces run.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.tensor_parallel import column_linear, row_linear
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
        self.heads, self.head_dim = heads, hidden // heads
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)
        self.tp = None  # the model group once sharded

    def forward(self, x, valid=None):
        def heads(layer):  # this rank's heads when sharded
            y = column_linear(x, layer, self.tp)
            return y.view(*y.shape[:-1], -1, self.head_dim)
        return attend_heads(heads(self.query), heads(self.key),
                            heads(self.value), valid)


class _DenseNorm(nn.Module):
    """HF's `*Output`: dense, residual, LayerNorm."""

    def __init__(self, d_in: int, hidden: int):
        super().__init__()
        self.dense = nn.Linear(d_in, hidden)
        self.LayerNorm = nn.LayerNorm(hidden, eps=LN_EPS)

    def forward(self, h, residual, tp=None):
        return self.LayerNorm(residual + row_linear(h, self.dense, tp))


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
        self.ffn_tp = None  # the model group once sharded

    def forward(self, x, valid=None):
        x = self.attention.output(self.attention.self(x, valid), x,
                                  self.attention.self.tp)
        h = F.gelu(column_linear(x, self.intermediate.dense,
                                 self.ffn_tp))  # erf form
        return self.output(h, x, self.ffn_tp)


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
