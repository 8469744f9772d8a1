"""ViLBERT bi-directional co-attention (counterpart of
`gpv_tpu/nn/coattention.py`).

Reference `exp/gpv/models/vilbert.py` `BertConnectionLayer` (:859):
`BertBiAttention` (16 heads over 768-d; each stream's queries read the
other stream's keys/values), `BertBiOutput` (per-stream dense + residual +
LayerNorm eps 1e-12) and a per-stream FFN (3072). GPV feeds stream 1 with
TEXT and stream 2 with the vision queries (`gpv.py:147-154`).

Names follow the reference, quirk included: stream 1 runs through the
`v_*` FFN weights (`v_intermediate`, `v_output`) and stream 2 through the
`t_*` ones. Deterministic calls run both directions of the attention as
one launch of the fused kernel K2 (`ops.attention.fused_biattention`);
training calls take the differentiable `attend_train` per direction, with
dropout on the probabilities and after the dense layers, as the JAX module
places it.
"""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ..ops.attention import fused_biattention
from .layers import attend_train, dropout

LN_EPS = 1e-12
ACTS = {"gelu": F.gelu, "relu": F.relu, "swish": F.silu}


class BiAttention(nn.Module):
    """Returns (ctx1, ctx2): ctx1 = softmax(Q2 K1^T) V1 (stream 2 reading
    stream 1), ctx2 = softmax(Q1 K2^T) V2 (stream 1 reading stream 2)."""

    def __init__(self, dim: int = 768, num_heads: int = 16,
                 dropout: float = 0.0, dropout2: float | None = None):
        super().__init__()
        self.num_heads = num_heads
        # attention-probability dropout of ctx1 and of ctx2
        self.rates = (dropout, dropout if dropout2 is None else dropout2)
        for name in ("query", "key", "value"):
            for s in ("1", "2"):
                setattr(self, name + s, nn.Linear(dim, dim))

    def forward(self, x1, x2, valid1=None, valid2=None,
                deterministic: bool = True):
        split = lambda y: y.view(*y.shape[:-1], self.num_heads, -1)  # noqa
        q1, k1, v1, q2, k2, v2 = (
            split(self.query1(x1)), split(self.key1(x1)),
            split(self.value1(x1)), split(self.query2(x2)),
            split(self.key2(x2)), split(self.value2(x2)))
        if not deterministic:
            return (attend_train(q2, k1, v1, valid1, rate=self.rates[0]),
                    attend_train(q1, k2, v2, valid2, rate=self.rates[1]))
        ctx1, ctx2 = fused_biattention(q1, k1, v1, q2, k2, v2, valid1,
                                       valid2)
        return ctx1.flatten(2), ctx2.flatten(2)


class _BiOutput(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dense1 = nn.Linear(dim, dim)
        self.LayerNorm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.dense2 = nn.Linear(dim, dim)
        self.LayerNorm2 = nn.LayerNorm(dim, eps=LN_EPS)


class _Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int, norm: bool = False):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)
        if norm:
            self.LayerNorm = nn.LayerNorm(d_out, eps=LN_EPS)


class CoAttentionLayer(nn.Module):
    """Bi-attention + per-stream residual/LayerNorm + per-stream FFN.
    `act`/`intermediate`/`dropout` are stream 1's (`v_*`),
    `act2`/`intermediate2`/`dropout2` stream 2's; `attn_dropout` and
    `attn_dropout2` the attention probabilities' (None: `dropout`, then
    stream 1's); None ties stream 2 to stream 1."""

    def __init__(self, dim: int = 768, num_heads: int = 16,
                 intermediate: int = 3072, intermediate2: int | None = None,
                 act: str = "gelu", act2: str | None = None,
                 dropout: float = 0.0, dropout2: float | None = None,
                 attn_dropout: float | None = None,
                 attn_dropout2: float | None = None):
        super().__init__()
        attn1 = dropout if attn_dropout is None else attn_dropout
        self.rates = (dropout, dropout if dropout2 is None else dropout2)
        act2 = act if act2 is None else act2
        for a in (act, act2):
            if a not in ACTS:  # same loud failure as the reference's ACT2FN
                raise ValueError(f"unsupported co-attention activation {a!r}"
                                 f" (expected one of {sorted(ACTS)})")
        self.act1, self.act2 = ACTS[act], ACTS[act2]
        inter2 = intermediate if intermediate2 is None else intermediate2
        self.biattention = BiAttention(dim, num_heads, attn1,
                                       attn_dropout2)
        self.biOutput = _BiOutput(dim)
        self.v_intermediate = _Dense(dim, intermediate)
        self.v_output = _Dense(intermediate, dim, norm=True)
        self.t_intermediate = _Dense(dim, inter2)
        self.t_output = _Dense(inter2, dim, norm=True)

    def forward(self, x1, x2, valid1=None, valid2=None,
                deterministic: bool = True):
        ctx1, ctx2 = self.biattention(x1, x2, valid1, valid2, deterministic)
        out = self.biOutput

        def drop1(x):
            return dropout(x, self.rates[0], deterministic)

        def drop2(x):
            return dropout(x, self.rates[1], deterministic)

        # stream 1 absorbs what it read from stream 2 (ctx2), and vice versa
        a1 = out.LayerNorm1(x1 + drop1(out.dense1(ctx2)))
        a2 = out.LayerNorm2(x2 + drop2(out.dense2(ctx1)))
        h1 = drop1(self.v_output.dense(self.act1(
            self.v_intermediate.dense(a1))))
        h2 = drop2(self.t_output.dense(self.act2(
            self.t_intermediate.dense(a2))))
        return (self.v_output.LayerNorm(a1 + h1),
                self.t_output.LayerNorm(a2 + h2))
