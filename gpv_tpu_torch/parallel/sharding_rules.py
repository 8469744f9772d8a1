"""Parameter sharding rules for tensor parallelism on the mesh's `model`
axis (counterpart of `gpv_tpu/parallel/sharding_rules.py`).

The JAX rules, on the reference torch names the port keeps:
  - column-parallel (the output dim shards; torch dim 0 of `(out, in)`):
    the kernels of `q_proj k_proj v_proj linear1 intermediate ffn_in1
    ffn_in2 query1 key1 value1 query2 key2 value2`, which are here the
    packed `in_proj_weight` of every `MultiHeadAttention`, `linear1`,
    BERT's `attention.self.{query,key,value}` and `intermediate.dense`,
    co-attention's `biattention.{query,key,value}{1,2}` and
    `{v,t}_intermediate.dense`;
  - row-parallel (the input dim shards; torch dim 1): `out_proj linear2
    output ffn_out1 ffn_out2`, here `out_proj`, `linear2`, BERT's
    `attention.output.dense` and `output.dense`, co-attention's
    `{v,t}_output.dense`;
  - everything else replicated: every bias, LayerNorm, conv, embedding,
    joiner and head, and co-attention's `biOutput.dense1` / `dense2`,
    which neither JAX list names.
Only 2-D weights shard, and (`make_param_shardings`) only where the
sharded dim divides by the group's size; with a group of 1 nothing
shards.

The packed `in_proj_weight` `(3D, D)` is three column-parallel matrices:
rank m holds the m-th row block of each of its q, k and v chunks
(`chunks` 3), not rows [m·3D/M, (m+1)·3D/M). So q/k/v's column shards
are contiguous head groups, and each rank attends over its own heads.

The head rule (where this package differs from GSPMD): an attention
block whose width divides by the group's size but whose head count does
not stays replicated whole, q/k/v and output projection alike, since a
per-head kernel cannot split a head; `ShardingRules.replicated_heads`
names such blocks. GSPMD shards them all the same.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, \
    Tuple

import torch
from torch import nn

_COLUMN = ("linear1", "intermediate", "v_intermediate", "t_intermediate",
           "query", "key", "value", "query1", "key1", "value1", "query2",
           "key2", "value2")
_ROW = ("out_proj", "linear2", "output", "v_output", "t_output")


class Spec(NamedTuple):
    """How one leaf shards: along torch `dim`, each of its `chunks`
    equal blocks along it split over the group; `full_shape` whole."""
    dim: int
    chunks: int
    full_shape: Tuple[int, ...]


class ShardingRules(NamedTuple):
    """`dims`: every parameter's sharded dim (None: replicated) after the
    divisibility and head rules; `specs`: the sharded ones; and the
    attention blocks the head rule kept replicated."""
    size: int
    dims: Dict[str, Optional[int]]
    specs: Dict[str, Spec]
    replicated_heads: Tuple[str, ...]


def param_partition_spec(name: str, shape) -> Optional[int]:
    """The torch dim of parameter `name` that the JAX rule shards: 0
    (column-parallel), 1 (row-parallel) or None (replicated)."""
    keys = name.split(".")
    if len(shape) != 2:
        return None
    if keys[-1] == "in_proj_weight":
        return 0
    if keys[-1] != "weight" or len(keys) < 2:
        return None
    owner = keys[-3] if keys[-2] == "dense" and len(keys) >= 3 else keys[-2]
    if owner in _COLUMN:
        return 0
    if owner in _ROW:
        return 1
    return None


def chunks_of(name: str) -> int:
    """3 for a packed q/k/v matrix, else 1."""
    return 3 if name.endswith("in_proj_weight") else 1


def attention_blocks(model: nn.Module) -> Iterator[Tuple[str, int,
                                                         List[str]]]:
    """(module name, heads, the block's projection weights) of every
    attention block: packed `MultiHeadAttention`s, BERT's self-attention
    with its `attention.output.dense`, co-attention's `biattention`."""
    for name, m in model.named_modules():
        if hasattr(m, "in_proj_weight"):
            yield name, m.num_heads, [f"{name}.in_proj_weight",
                                      f"{name}.out_proj.weight"]
        elif name.endswith("biattention"):
            yield name, m.num_heads, [f"{name}.{p}{s}.weight"
                                      for p in ("query", "key", "value")
                                      for s in ("1", "2")]
        elif name.endswith("attention.self"):
            parent = name[:-len(".self")]
            yield name, m.heads, [f"{name}.{p}.weight"
                                  for p in ("query", "key", "value")] + [
                f"{parent}.output.dense.weight"]


def make_param_shardings(model: nn.Module, size: int) -> ShardingRules:
    """The rules for a model group of `size` ranks: a leaf shards where
    the JAX rule says and its dim divides by `size` (each q/k/v chunk's,
    for the packed matrix), except in the blocks the head rule keeps
    replicated (module docstring)."""
    dims: Dict[str, Optional[int]] = {}
    shapes = {}
    for name, p in model.named_parameters():
        dim = param_partition_spec(name, p.shape) if size > 1 else None
        if dim is not None and (p.shape[dim] // chunks_of(name)) % size:
            dim = None
        dims[name], shapes[name] = dim, tuple(p.shape)
    kept = []
    for block, heads, names in attention_blocks(model):
        if size > 1 and heads % size and any(dims.get(n) is not None
                                             for n in names):
            kept.append(block)
            for n in names:
                dims[n] = None
    specs = {n: Spec(d, chunks_of(n), shapes[n]) for n, d in dims.items()
             if d is not None}
    return ShardingRules(size, dims, specs, tuple(kept))


def _index(length: int, chunks: int, rank: int, size: int,
           device) -> torch.Tensor:
    block = length // chunks
    n = block // size
    return torch.cat([torch.arange(i * block + rank * n,
                                   i * block + (rank + 1) * n, device=device)
                      for i in range(chunks)])


def shard_tensor(full: torch.Tensor, dim: int, chunks: int, rank: int,
                 size: int) -> torch.Tensor:
    """Rank `rank`'s shard of `full` (a new tensor)."""
    return full.index_select(dim, _index(full.shape[dim], chunks, rank,
                                         size, full.device))


def place_shard(full: torch.Tensor, shard: torch.Tensor, dim: int,
                chunks: int, rank: int, size: int) -> torch.Tensor:
    """Write rank `rank`'s `shard` into `full` in place; returns `full`."""
    return full.index_copy_(dim, _index(full.shape[dim], chunks, rank, size,
                                        full.device), shard)


def shard_state_dict(full: Dict[str, torch.Tensor], specs: Dict[str, Spec],
                     rank: int, size: int) -> Dict[str, torch.Tensor]:
    """Rank `rank`'s state dict from a whole one: each sharded leaf
    (`specs`) sliced, the rest as they are."""
    return {k: (shard_tensor(v, specs[k].dim, specs[k].chunks, rank, size)
                if k in specs else v) for k, v in full.items()}


def gather_state_dict(parts: Sequence[Dict[str, torch.Tensor]],
                      specs: Dict[str, Spec]) -> Dict[str, torch.Tensor]:
    """The whole state dict from every rank's (`parts`, in rank order),
    bit for bit; replicated entries are rank 0's."""
    size = len(parts)
    out = dict(parts[0])
    for k, spec in specs.items():
        if k not in out:
            continue
        full = parts[0][k].new_empty(spec.full_shape)
        for r, part in enumerate(parts):
            place_shard(full, part[k], spec.dim, spec.chunks, r, size)
        out[k] = full
    return out
