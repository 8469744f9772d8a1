"""Core building blocks (PyTorch counterpart of `gpv_tpu/nn/layers.py`).

- `MultiHeadAttention`: torch `nn.MultiheadAttention` parameter layout
  (packed `in_proj_weight`/`in_proj_bias`, `out_proj`), so the reference
  DETR and text-decoder state dicts load as they are. `project_q`,
  `project_kv` and `attend` stay separate so decode can cache K/V. With
  `tp` set (`models.gpv.shard_params`) it is one rank's share of the
  block: q/k/v column-parallel by chunk (its heads), `out_proj`
  row-parallel (`parallel.tensor_parallel`).
- `attend_heads`: the one place where attention over (B, T, H, Dh) heads
  runs. Deterministic calls go to the fused kernel K1
  (`ops.attention.fused_attention`); training calls take `attend_train`.
- `attend_train`: the differentiable formulation the JAX package computes
  outside any Pallas kernel in training (`gpv_tpu/nn/layers.py:71-84`),
  because the kernels are forward-only: invalid keys set to -1e9, the
  additive causal mask, softmax in fp32, dropout on the probabilities, a
  cast to the compute dtype, then P·V. It is the port of that product, not
  a fallback: the route is chosen by `deterministic` alone.
- `dropout`: dropout drawing from the generator a train step installs with
  `dropout_generator` (seeded from the step count, as the JAX step folds
  the step into its key), or from torch's default generator. Under tensor
  parallelism a rank's head- or width-sharded tensor takes its slice of
  the mask drawn for the whole tensor, so that the ranks of a model group
  draw alike and the masks are those of the unsharded model.
- `remat`: a region whose activations the backward recomputes
  (`tpu.remat`, the JAX package's `nn.remat`), with the same dropout masks.
- `MLP`: DETR's ReLU box-head MLP.
- `FrozenBatchNorm`: BN with frozen statistics, NCHW.

LayerNorm is torch's own `nn.LayerNorm` (eps 1e-5 by default, as in the
JAX package's `LayerNorm`).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import NEG, fused_attention
from ..parallel.tensor_parallel import copy_to_model, row_linear

_rng = threading.local()


@contextlib.contextmanager
def dropout_generator(generator: Optional[torch.Generator]):
    """Draw every `dropout` mask of this thread from `generator` inside the
    block (a generator on the activations' device)."""
    saved = getattr(_rng, "generator", None)
    _rng.generator = generator
    try:
        yield
    finally:
        _rng.generator = saved


def dropout(x: torch.Tensor, rate: float, deterministic: bool = True,
            tp=None, dim: int = -1) -> torch.Tensor:
    """Inverted dropout: keep each element with probability 1 - rate and
    scale the kept ones by 1 / (1 - rate). The identity when
    `deterministic` or at rate 0. With `tp` (a model group), `x` is this
    rank's shard along `dim` of a tensor `tp.size` times as wide there,
    and its mask is this rank's slice of the mask drawn for the whole."""
    if deterministic or rate == 0.0:
        return x
    shape = list(x.shape)
    if tp is not None:
        shape[dim] *= tp.size
    keep = torch.rand(shape, generator=getattr(_rng, "generator", None),
                      device=x.device) >= rate
    if tp is not None:
        n = x.shape[dim]
        keep = keep.narrow(dim, tp.rank * n, n)
    return x * keep.to(x.dtype) / (1.0 - rate)


def remat(fn, *args, **kwargs):
    """`fn(*args, **kwargs)` with its activations dropped after the forward
    and recomputed in the backward (`torch.utils.checkpoint`, the
    non-reentrant form: the reentrant one needs an input that requires
    grad, and the frozen stem and a frozen DETR give none).

    `checkpoint` restores only torch's default generators for the
    recompute, and the recompute runs on autograd's thread, where no
    `dropout_generator` is installed. So the forward captures the state of
    the installed generator, and the recompute draws from a generator
    restored to it: the backward sees the forward's masks. The forward
    itself draws from the installed generator, which advances as it would
    without remat."""
    gen = getattr(_rng, "generator", None)
    if gen is None:
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)
    state = gen.get_state()
    calls = []

    def run(*a, **kw):
        if not calls:  # the forward
            calls.append(1)
            return fn(*a, **kw)
        replay = torch.Generator(device=gen.device)
        replay.set_state(state)
        with dropout_generator(replay):
            return fn(*a, **kw)

    return checkpoint(run, *args, use_reentrant=False, **kwargs)


def attend_train(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                 key_valid: Optional[torch.Tensor] = None,
                 causal: bool = False, rate: float = 0.0,
                 tp=None) -> torch.Tensor:
    """Differentiable attention: (B,Tq,H,Dh) x (B,Tk,H,Dh)^2 -> (B,Tq,H*Dh)
    in the compute dtype (v's). With `tp`, the H heads are this rank's
    share (`dropout`)."""
    B, Tq, H, Dh = qh.shape
    logits = torch.einsum("bqhd,bkhd->bhqk", qh * (1.0 / Dh ** 0.5),
                          kh).float()
    if causal:
        Tk = kh.shape[1]
        keep = torch.ones(Tq, Tk, dtype=torch.bool, device=qh.device).tril()
        logits = logits + torch.where(keep, 0.0, NEG)
    if key_valid is not None:
        logits = torch.where(key_valid[:, None, None, :], logits, NEG)
    probs = dropout(logits.softmax(-1).to(vh.dtype), rate, False, tp, 1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vh).reshape(B, Tq, H * Dh)


def attend_heads(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                 key_valid: Optional[torch.Tensor] = None,
                 causal: bool = False, deterministic: bool = True,
                 rate: float = 0.0, tp=None) -> torch.Tensor:
    """(B,Tq,H,Dh) x (B,Tk,H,Dh)^2 -> (B,Tq,H*Dh): through K1 when
    `deterministic`, else `attend_train` with attention dropout `rate`.
    key_valid: (B,Tk) bool, True = valid key. `tp` as in `attend_train`."""
    if deterministic:
        return fused_attention(qh, kh, vh, key_valid, causal).flatten(2)
    return attend_train(qh, kh, vh, key_valid, causal, rate, tp)


def enter_model(xs, tp):
    """`copy_to_model` of each distinct tensor of `xs` once (a block's
    inputs are often one tensor twice)."""
    if tp is None:
        return tuple(xs)
    seen = {}
    return tuple(seen.setdefault(id(x), copy_to_model(x, tp)) for x in xs)


class MultiHeadAttention(nn.Module):
    """Multi-head attention over (B, T, D) streams; key_valid True = VALID."""

    def __init__(self, dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} not divisible by {num_heads} heads")
        self.dim, self.num_heads, self.dropout = dim, num_heads, dropout
        self.head_dim = dim // num_heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        self.tp = None  # the model group once sharded

    @property
    def local_heads(self) -> int:
        """The heads this rank computes: all, or its share when sharded."""
        return self.in_proj_weight.shape[0] // 3 // self.head_dim

    def _proj(self, x: torch.Tensor, i: int) -> torch.Tensor:
        # the weight holds this rank's rows of each q/k/v chunk; the bias
        # stays whole (replicated), so its rows are taken here
        d = self.in_proj_weight.shape[0] // 3
        off = i * self.dim + (0 if self.tp is None else self.tp.rank * d)
        y = F.linear(x, self.in_proj_weight[i * d:(i + 1) * d],
                     self.in_proj_bias[off:off + d])
        return y.view(*x.shape[:-1], d // self.head_dim, self.head_dim)

    def project_q(self, q: torch.Tensor) -> torch.Tensor:
        return self._proj(q, 0)

    def project_kv(self, k: torch.Tensor, v: torch.Tensor):
        return self._proj(k, 1), self._proj(v, 2)

    def attend(self, qh, kh, vh, key_valid=None, causal: bool = False,
               deterministic: bool = True):
        """qh: (B,Tq,H,Dh), kh/vh: (B,Tk,H,Dh) -> (B,Tq,D)."""
        return row_linear(attend_heads(qh, kh, vh, key_valid, causal,
                                       deterministic, self.dropout, self.tp),
                          self.out_proj, self.tp)

    def forward(self, q, k, v, key_valid=None, causal: bool = False,
                deterministic: bool = True):
        q, k, v = enter_model((q, k, v), self.tp)
        kh, vh = self.project_kv(k, v)
        return self.attend(self.project_q(q), kh, vh, key_valid, causal,
                           deterministic)


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
        # in x's dtype, as the JAX package casts scale and shift
        scale, shift = (t.to(x.dtype)[:, None, None]
                        for t in self.scale_shift())
        return x * scale + shift
