"""The multitask train step, on one card or one rank of a data-parallel
group (counterpart of `gpv_tpu/parallel/train_step.py`).

Reference hot loop `exp/gpv/train_distr.py:399-471`: teacher-forced
forward -> GPVCriterion -> backward -> clip the DETR gradients at 0.1 ->
one AdamW step. Parameters and AdamW state stay fp32; with a bf16 compute
dtype the forward runs under autocast (softmax, the losses and the answer
logits stay fp32). The Hungarian matching copies the batch's costs to the
host once and solves there (`ops.matcher`).

- uint8 images are normalised on the device;
- frozen parameters (`train.optimizer.frozen_names`: BERT, the stem, the
  vocab embedding, the dead tokens, and DETR under `freeze_detr`, exactly
  `frozen_detr_paths` when given) get `requires_grad=False`, so no
  backward runs through them;
- with the collator's dedup fields, frozen BERT encodes the unique query
  rows once, under `no_grad` and through K1, outside the accumulation loop;
- `grad_accum` splits the batch into microbatches that each normalise
  their own loss (the reference's per-GPU DDP normalisation); gradients
  and losses are averaged;
- dropout draws from a generator seeded from (seed, step), as the JAX step
  folds the step into its key: one device, one seed and one step give one
  loss. A rank folds its data index in too, so that data peers draw
  different masks for their rows, as the JAX global mask does, while the
  ranks of a model group draw alike.

Data parallelism: in a joined process group (`parallel.mesh`) the model
runs under `DistributedDataParallel` (the reference's DDP) on this rank's
rows of the global batch (`datasets.loader`). The JAX step computes one
loss over the global batch; the criterion gives each rank its part of it
times the world size (global normalisers), so DDP's gradient mean is the
global loss's gradient, microbatch by microbatch. Every microbatch but the
last runs under `no_sync`, so the accumulated gradient is all-reduced once.
The all-reduce is DDP's default one, made through a communication hook
(`allreduce_hook`) that counts each bucket it enqueues in `COUNTERS`
(`ddp.allreduce_calls`, `ddp.allreduce_bytes`) inside the span
`train.ddp.hook`.
Names (frozen parameters, the clip's groups, the optimizer's groups) are
resolved on the inner module, whose names are the reference's; the
returned losses are the mean over ranks, the global batch's.

Tensor parallelism (a model sharded by `models.gpv.shard_params`): the
ranks of a model group take the same rows and compute one replica
between them (`parallel.tensor_parallel`), as the JAX step with sharded
parameters and replicated AdamW state (`gpv_tpu/parallel/train_step.py:
195-211`). Data parallelism then runs over the data group (the ranks of
one model index), and not at all with one model group: DDP, the
criterion's normalisers and the mean losses are the data group's. After
the backward the replicated column-parallel biases, of which a rank read
its slice, sum their gradients over the model group, and the other
replicated trainable leaves average theirs (`tensor_parallel.
sync_replicated_grads`); the clip takes the
whole gradient's norm (`train.optimizer.clip_detr_grads`); the Hungarian
assignment, solved on every rank from the same costs, is checked equal
over the group (`tensor_parallel.check_replicated`).
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.algorithms.ddp_comm_hooks import default_hooks
from torch.nn.parallel import DistributedDataParallel

from ..losses.criterion import LossConfig, gpv_criterion
from ..nn.layers import dropout_generator
from ..ops.image import normalize_image
from ..train.optimizer import clip_detr_grads, frozen_names
from ..utils.profiling import span
from . import mesh
from .tensor_parallel import sync_replicated_grads


# the buckets DDP's all-reduce enqueued, and their bytes (`allreduce_hook`)
COUNTERS = {"ddp.allreduce_calls": 0, "ddp.allreduce_bytes": 0}
_counter_lock = threading.Lock()


def allreduce_hook(process_group, bucket):
    """DDP's default all-reduce of a gradient bucket (the mean over the
    group), counted in `COUNTERS`; its enqueue is the span
    `train.ddp.hook`."""
    with span("train.ddp.hook"):
        buf = bucket.buffer()
        with _counter_lock:
            COUNTERS["ddp.allreduce_calls"] += 1
            COUNTERS["ddp.allreduce_bytes"] += buf.numel() * buf.element_size()
        return default_hooks.allreduce_hook(process_group, bucket)


@dataclass
class TrainState:
    """What a step updates: the model's parameters, the optimizer and its
    lr schedule, and the count of updates made."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0


def batch_to_device(batch: Dict[str, np.ndarray],
                    device) -> Dict[str, torch.Tensor]:
    """A collated batch (numpy arrays or tensors) -> tensors on `device`:
    integer fields as int64, the rest as they are (uint8 images stay
    uint8)."""
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(v))
        if t.dtype in (torch.int32, torch.int16, torch.int8):
            t = t.long()
        out[k] = t.to(device, non_blocking=True)
    return out


def make_train_step(model: nn.Module, loss_cfg: LossConfig,
                    clip_max_norm: float = 0.1, grad_accum: int = 1,
                    freeze_detr: bool = False, frozen_detr_paths=None,
                    dtype: torch.dtype = torch.float32, seed: int = 1):
    """Freeze `model`'s frozen parameters and return
    `step(state, batch) -> losses`, which updates `state` in place and
    returns the step's mean losses as 0-d tensors.

    `batch`: a collated dict (numpy or tensors): image (B,H,W,3) uint8 or
    normalised fp32; query_ids/query_valid (B,Tq); answer_ids (B,S);
    answer_lens, task_id, has_answer (B,); boxes (B,M,4); box_labels,
    box_valid (B,M); has_boxes (B,); optionally query_uniq_ids/valid
    (U,Tq) and query_gather (B,). The step's stages are the spans
    `train.upload`, `train.query_encode`, then per microbatch
    `train.forward` (the forward and the criterion, with the matcher's
    `train.matcher.wait` and `train.matcher.solve` inside) and
    `train.backward`, then `train.clip` and `train.adamw`
    (`utils.profiling`; none synchronises the card).

    In a joined process group the step runs as one rank of it under DDP
    (module docstring): `batch` is then this rank's rows; under tensor
    parallelism, its model group's rows."""
    frozen = frozen_names(model, freeze_detr, frozen_detr_paths)
    for name, p in model.named_parameters():
        if name in frozen:
            p.requires_grad_(False)
    trainable = [p for p in model.parameters() if p.requires_grad]
    if grad_accum < 1:
        raise ValueError(f"grad_accum {grad_accum} < 1")
    tp = getattr(model, "tp", None)
    groups = mesh.groups()
    # replicated trainable leaves: the biases that column-parallel layers
    # read a slice of, and the rest (`tensor_parallel` docstring)
    params = dict(model.named_parameters())
    specs = {} if tp is None else model.tp_rules.specs
    sliced = {n[:-len("weight")] + "bias" for n, spec in specs.items()
              if spec.dim == 0}  # `in_proj_weight` -> `in_proj_bias` too
    replicated = [p for n, p in params.items() if p.requires_grad
                  and n not in specs and n not in sliced]
    sliced = [params[n] for n in sorted(sliced)
              if n in params and params[n].requires_grad]
    distributed = dist.is_initialized() and (tp is None
                                             or groups.mesh.data > 1)
    group, data_index, world, forward = None, groups.data_index, 1, model
    if distributed:
        group, world = groups.data_group, groups.mesh.data
        device = next(model.parameters()).device
        # The forward reaches every trainable leaf but one: with
        # relevance_conditioning off, `relevance_tokens` is never read
        # (tests/test_torch_port_ddp.py lists the unreached leaves of each
        # variant). Only then must the reducer search for unused
        # parameters. Frozen leaves (requires_grad False) are not
        # registered at all; FrozenBN buffers never change, so nothing is
        # broadcast.
        forward = DistributedDataParallel(
            model, device_ids=[device] if device.type == "cuda" else None,
            process_group=group, broadcast_buffers=False,
            find_unused_parameters=not getattr(
                model, "relevance_conditioning", True))
        forward.register_comm_hook(group, allreduce_hook)

    def step(state: TrainState, batch):
        device = next(model.parameters()).device
        autocast = torch.autocast(device.type, dtype=dtype,
                                  enabled=dtype != torch.float32)
        with span("train.upload"):
            b = batch_to_device(batch, device)
        gen = torch.Generator(device=device)
        # the CPU generator keeps 32 bits of a seed; a data index's offset
        # (a 32-bit golden-ratio multiple) leaves index 0's seed as it was
        gen.manual_seed((seed * 1000003 + state.step
                         + data_index * 2654435761) % 2 ** 32)
        if "query_uniq_ids" in b:
            with span("train.query_encode"):
                with autocast:
                    uniq = model.encode_queries(b.pop("query_uniq_ids"),
                                                b.pop("query_uniq_valid"))
                b["query_enc"] = uniq[b.pop("query_gather")]
        B = b["query_ids"].shape[0]
        if B % grad_accum:
            raise ValueError(f"batch {B} not divisible by grad_accum "
                             f"{grad_accum}")
        m = B // grad_accum
        state.optimizer.zero_grad(set_to_none=True)
        total_losses: Dict[str, torch.Tensor] = {}
        for i in range(grad_accum):
            mb = {k: v[i * m:(i + 1) * m] for k, v in b.items()}
            images = mb["image"]
            # DDP all-reduces the accumulated gradients once, at the last
            sync = (forward.no_sync() if distributed and i < grad_accum - 1
                    else contextlib.nullcontext())
            with sync:
                with span("train.forward"):
                    if images.dtype == torch.uint8:
                        images = normalize_image(images.float() / 255.0)
                    with dropout_generator(gen), autocast:
                        outputs = forward(
                            images, mb["query_ids"], mb["answer_ids"],
                            image_valid=mb.get("image_valid"),
                            query_valid=mb["query_valid"], train=True,
                            query_enc=mb.get("query_enc"))
                        total, losses = gpv_criterion(
                            outputs, mb, loss_cfg, group, replicas=tp)
                with span("train.backward"):
                    (total / grad_accum).backward()
            for k, v in losses.items():
                total_losses[k] = total_losses.get(k, 0.0) + v.detach()
        with span("train.clip"):
            # a trainable leaf the forward did not reach takes a zero
            # gradient (AdamW then still decays it, as the JAX optimizer
            # does)
            for p in trainable:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            sync_replicated_grads(sliced, replicated, tp)
            clip_detr_grads(model, clip_max_norm)
        with span("train.adamw"):
            state.optimizer.step()
            state.scheduler.step()
        state.step += 1
        out = {k: v / grad_accum for k, v in total_losses.items()}
        if distributed:  # the mean over data peers: the global batch's
            flat = torch.stack([out[k] for k in out]).float()
            dist.all_reduce(flat, group=group)
            out = dict(zip(out, flat / world))
        return out

    return step
