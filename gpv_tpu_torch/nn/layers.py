"""Core building blocks (PyTorch counterpart of `gpv_tpu/nn/layers.py`).

- `MultiHeadAttention`: torch `nn.MultiheadAttention` parameter layout
  (packed `in_proj_weight`/`in_proj_bias`, `out_proj`), so the reference
  DETR and text-decoder state dicts load as they are. `project_q`,
  `project_kv` and `attend` stay separate so decode can cache K/V.
- `attend_heads`: the one place where attention over (B, T, H, Dh) heads
  runs; it calls the fused kernel K1 (`ops.attention.fused_attention`).
- `MLP`: DETR's ReLU box-head MLP.
- `FrozenBatchNorm`: BN with frozen statistics, NCHW.

LayerNorm is torch's own `nn.LayerNorm` (eps 1e-5 by default, as in the
JAX package's `LayerNorm`). Modules here are inference-only: the dropouts
of the JAX package are identities at inference and are left out.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import fused_attention


def attend_heads(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                 key_valid: Optional[torch.Tensor] = None,
                 causal: bool = False) -> torch.Tensor:
    """(B,Tq,H,Dh) x (B,Tk,H,Dh)^2 -> (B,Tq,H*Dh) through K1.
    key_valid: (B,Tk) bool, True = valid key."""
    return fused_attention(qh, kh, vh, key_valid, causal).flatten(2)


class MultiHeadAttention(nn.Module):
    """Multi-head attention over (B, T, D) streams; key_valid True = VALID."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} not divisible by {num_heads} heads")
        self.dim, self.num_heads = dim, num_heads
        self.head_dim = dim // num_heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def _proj(self, x: torch.Tensor, i: int) -> torch.Tensor:
        d = self.dim
        y = F.linear(x, self.in_proj_weight[i * d:(i + 1) * d],
                     self.in_proj_bias[i * d:(i + 1) * d])
        return y.view(*x.shape[:-1], self.num_heads, self.head_dim)

    def project_q(self, q: torch.Tensor) -> torch.Tensor:
        return self._proj(q, 0)

    def project_kv(self, k: torch.Tensor, v: torch.Tensor):
        return self._proj(k, 1), self._proj(v, 2)

    def attend(self, qh, kh, vh, key_valid=None, causal: bool = False):
        """qh: (B,Tq,H,Dh), kh/vh: (B,Tk,H,Dh) -> (B,Tq,D)."""
        return self.out_proj(attend_heads(qh, kh, vh, key_valid, causal))

    def forward(self, q, k, v, key_valid=None, causal: bool = False):
        kh, vh = self.project_kv(k, v)
        return self.attend(self.project_q(q), kh, vh, key_valid, causal)


class MLP(nn.Module):
    """ReLU MLP: num_layers Linear layers, ReLU between (not after last).
    Parameters `layers.{i}` as in the reference DETR box head."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class FrozenBatchNorm(nn.Module):
    """BatchNorm with frozen statistics and affine params, NCHW.
    Buffers as torchvision's FrozenBatchNorm2d names them."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def scale_shift(self):
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        return scale, self.bias - self.running_mean * scale

    def forward(self, x):
        scale, shift = self.scale_shift()
        return x * scale[:, None, None] + shift[:, None, None]
