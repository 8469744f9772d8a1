"""Tensor parallelism over a `model` process group: the collectives that
GSPMD inserts into the JAX package's sharded train step
(`gpv_tpu/parallel/train_step.py:195-211`, parameters laid out by
`gpv_tpu/parallel/sharding_rules.py`), written out for one process per
card.

A model group is `model` consecutive ranks (`parallel.mesh`). Its rank m
holds the m-th shard of every sharded leaf (`parallel.sharding_rules`) and
every other leaf whole, and every rank of the group runs the same rows.
Megatron's two conjugate operations give one all-reduce per attention
block and per FFN in the forward:
  - `copy_to_model` at a column-parallel layer's input: the identity
    forward; backward, the all-reduce of the input's gradient, which each
    rank computes from its own output columns only;
  - `reduce_from_model` at a row-parallel layer's output: the all-reduce
    of the ranks' partial products forward (the bias is added once, after
    it); the identity backward.
`gather_from_model` makes a width-sharded activation whole: co-attention's
context is head-sharded, while `biOutput.dense1` / `dense2`, which read
it, are replicated (the JAX rules name neither). Each rank writes its
columns into a zero-filled buffer of the full width and the buffers are
summed; backward takes the rank's columns of the gradient, which is the
same on every rank because everything after the gather is replicated.

Every collective here is an `all_reduce`. Ranks that share a card join
over gloo (`parallel.mesh.choose_backend`), and gloo implements only
`broadcast` and `all_reduce` for CUDA tensors; so an all-gather is the
all-reduce of a zero-filled full buffer, on NCCL and gloo alike. State
(parameters, AdamW moments) is gathered on its int32 bits, so that one
value plus zeros is that value bit for bit (a float sum turns -0.0 into
+0.0).

The biases of column-parallel layers stay replicated, as the JAX package
replicates every bias: a rank adds its slice of the bias, so its gradient
is non-zero on that slice alone, and `sync_replicated_grads` sums those
gradients over the group after the backward. Every other replicated
trainable leaf is computed by each rank of the group from the same
inputs, but some of a card's backward kernels (cuDNN's weight gradients,
atomic scatters) do not add in a fixed order, so the ranks' gradients
may differ in their last bits and the replicas would drift apart; so
`sync_replicated_grads` also averages them over the group, in the same
all-reduce of one flat buffer. The replicated leaves then take one
gradient, clip and AdamW update on every rank of the group and stay
bit-equal.

`STATS` counts the all-reduces (every one, forward and backward) and
their bytes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, NamedTuple, Optional

import torch
import torch.distributed as dist

from . import sharding_rules as rules


class ModelGroup(NamedTuple):
    """This rank's model group: the process group, the rank's index in it
    (its model index) and the group's size."""
    group: object
    rank: int
    size: int

    def __deepcopy__(self, memo):  # a process group is not copied
        return self


@dataclass
class Stats:
    """All-reduces over model groups since the last `reset`: their count,
    bytes, and count by kind."""
    calls: int = 0
    bytes: int = 0
    by_kind: Dict[str, int] = field(default_factory=dict)

    def reset(self) -> None:
        self.calls, self.bytes, self.by_kind = 0, 0, {}


STATS = Stats()


def all_reduce(x: torch.Tensor, mg: ModelGroup, kind: str,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce `x` in place over the model group (a sum unless `op`);
    counted under `kind`."""
    STATS.calls += 1
    STATS.bytes += x.numel() * x.element_size()
    STATS.by_kind[kind] = STATS.by_kind.get(kind, 0) + 1
    dist.all_reduce(x, op=op, group=mg.group)
    return x


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg):
        ctx.mg = mg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.mg, "backward"), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg):
        return all_reduce(x.contiguous().clone(), mg, "forward")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg):
        ctx.mg, n = mg, x.shape[-1]
        full = x.new_zeros(*x.shape[:-1], n * mg.size)
        full[..., mg.rank * n:(mg.rank + 1) * n] = x
        return all_reduce(full, mg, "forward")

    @staticmethod
    def backward(ctx, g):
        n = g.shape[-1] // ctx.mg.size
        return g[..., ctx.mg.rank * n:(ctx.mg.rank + 1) * n].contiguous(), None


def copy_to_model(x: torch.Tensor, mg: Optional[ModelGroup]) -> torch.Tensor:
    """`x`, whose gradient is summed over the group in the backward."""
    if mg is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToModel.apply(x, mg)


def reduce_from_model(x: torch.Tensor,
                      mg: Optional[ModelGroup]) -> torch.Tensor:
    """The sum of `x` over the group."""
    return x if mg is None else _ReduceFromModel.apply(x, mg)


def gather_from_model(x: torch.Tensor,
                      mg: Optional[ModelGroup]) -> torch.Tensor:
    """The group's last-dim shards of `x`, in rank order: the whole."""
    return x if mg is None else _GatherFromModel.apply(x, mg)


def column_linear(x: torch.Tensor, layer: torch.nn.Linear,
                  mg: Optional[ModelGroup]) -> torch.Tensor:
    """A column-parallel Linear (its weight holds this rank's output rows;
    its bias stays whole): this rank's output columns of `layer(x)`."""
    if mg is None:
        return layer(x)
    w, n = layer.weight, layer.weight.shape[0]
    b = None if layer.bias is None else layer.bias[mg.rank * n:
                                                   (mg.rank + 1) * n]
    return torch.nn.functional.linear(copy_to_model(x, mg), w, b)


def row_linear(x: torch.Tensor, layer: torch.nn.Linear,
               mg: Optional[ModelGroup]) -> torch.Tensor:
    """A row-parallel Linear (its weight holds this rank's input columns,
    `x` this rank's input columns): the whole `layer` output, the bias
    added once after the sum."""
    if mg is None:
        return layer(x)
    y = reduce_from_model(torch.nn.functional.linear(x, layer.weight), mg)
    return y if layer.bias is None else y + layer.bias


def sync_replicated_grads(sliced: Iterable[torch.nn.Parameter],
                          replicated: Iterable[torch.nn.Parameter],
                          mg: Optional[ModelGroup]) -> None:
    """Sum the gradients of `sliced` (replicated leaves a rank reads a
    slice of) and average those of `replicated` (leaves each rank
    computes whole) over the group, in one all-reduce of one flat
    buffer."""
    sliced = [p.grad for p in sliced if p.grad is not None]
    whole = [p.grad for p in replicated if p.grad is not None]
    grads = sliced + whole
    if mg is None or not grads:
        return
    flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), mg,
                      "gradients")
    parts = flat.split([g.numel() for g in grads])
    for i, (g, part) in enumerate(zip(grads, parts)):
        g.copy_(part.view_as(g) if i < len(sliced)
                else part.view_as(g) / mg.size)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.element_size() == 4 else t


def gather_shard(local: torch.Tensor, full_shape, dim: int, chunks: int,
                 mg: ModelGroup) -> torch.Tensor:
    """The whole of a leaf from the group's shards, bit for bit: each rank
    places its shard in a zero-filled buffer, summed on its int32 bits."""
    full = torch.zeros(full_shape, dtype=local.dtype, device=local.device)
    rules.place_shard(full, local, dim, chunks, mg.rank, mg.size)
    bits = _bits(full)
    all_reduce(bits, mg, "gather")
    return bits.view(local.dtype)


def gather_shards(local: Dict[str, torch.Tensor], specs: dict,
                  mg: Optional[ModelGroup]) -> Dict[str, torch.Tensor]:
    """A rank's state dict with every sharded leaf (`specs`: name ->
    `sharding_rules.Spec`) made whole over the group; the other entries as
    they are. Every rank of the group must call it."""
    if mg is None:
        return dict(local)
    out = dict(local)
    for name, spec in specs.items():
        if name in local:
            out[name] = gather_shard(local[name], spec.full_shape, spec.dim,
                                     spec.chunks, mg)
    return out


def check_replicated(x: torch.Tensor, mg: Optional[ModelGroup],
                     what: str) -> None:
    """Raise unless `x` is the same on every rank of the group (compared
    by a position-weighted checksum, reduced by max of it and its
    negation)."""
    if mg is None:
        return
    flat = x.detach().reshape(-1).double()
    s = (flat * torch.arange(1, flat.numel() + 1, dtype=torch.float64,
                             device=flat.device)).sum()
    both = all_reduce(torch.stack([s, -s]), mg, "check", dist.ReduceOp.MAX)
    if bool(both[0] != -both[1]):
        raise RuntimeError(f"{what} differs between the ranks of a model "
                           "group, which must compute it alike")
