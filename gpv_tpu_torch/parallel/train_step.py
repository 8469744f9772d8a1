"""The multitask train step on one card (counterpart of
`gpv_tpu/parallel/train_step.py`).

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
  loss.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..losses.criterion import LossConfig, gpv_criterion
from ..nn.layers import dropout_generator
from ..ops.image import normalize_image
from ..train.optimizer import clip_detr_grads, frozen_names


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


class _Marks:
    """Wall ms per stage of a step, synchronising the card at each mark;
    a no-op unless asked for."""

    def __init__(self, timings: Optional[dict], device):
        self.timings, self.device = timings, device
        self.t = time.perf_counter()

    def __call__(self, name: str) -> None:
        if self.timings is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.timings[name] = self.timings.get(name, 0.0) + 1e3 * (now -
                                                                 self.t)
        self.t = now


def make_train_step(model: nn.Module, loss_cfg: LossConfig,
                    clip_max_norm: float = 0.1, grad_accum: int = 1,
                    freeze_detr: bool = False, frozen_detr_paths=None,
                    dtype: torch.dtype = torch.float32, seed: int = 1):
    """Freeze `model`'s frozen parameters and return
    `step(state, batch, timings=None) -> losses`, which updates `state`
    in place and returns the step's mean losses as 0-d tensors.

    `batch`: a collated dict (numpy or tensors): image (B,H,W,3) uint8 or
    normalised fp32; query_ids/query_valid (B,Tq); answer_ids (B,S);
    answer_lens, task_id, has_answer (B,); boxes (B,M,4); box_labels,
    box_valid (B,M); has_boxes (B,); optionally query_uniq_ids/valid
    (U,Tq) and query_gather (B,). `timings`, a dict, receives the ms of
    upload, query_encode, forward (with the matching), backward, clip
    and adamw, each after a synchronisation."""
    frozen = frozen_names(model, freeze_detr, frozen_detr_paths)
    for name, p in model.named_parameters():
        if name in frozen:
            p.requires_grad_(False)
    trainable = [p for p in model.parameters() if p.requires_grad]
    if grad_accum < 1:
        raise ValueError(f"grad_accum {grad_accum} < 1")

    def step(state: TrainState, batch, timings: Optional[dict] = None):
        device = next(model.parameters()).device
        autocast = torch.autocast(device.type, dtype=dtype,
                                  enabled=dtype != torch.float32)
        mark = _Marks(timings, device)
        b = batch_to_device(batch, device)
        mark("upload")
        gen = torch.Generator(device=device)
        gen.manual_seed(seed * 1000003 + state.step)
        if "query_uniq_ids" in b:
            with autocast:
                uniq = model.encode_queries(b.pop("query_uniq_ids"),
                                            b.pop("query_uniq_valid"))
            b["query_enc"] = uniq[b.pop("query_gather")]
        mark("query_encode")
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
            if images.dtype == torch.uint8:
                images = normalize_image(images.float() / 255.0)
            with dropout_generator(gen), autocast:
                outputs = model(images, mb["query_ids"], mb["answer_ids"],
                                image_valid=mb.get("image_valid"),
                                query_valid=mb["query_valid"], train=True,
                                query_enc=mb.get("query_enc"))
                total, losses = gpv_criterion(outputs, mb, loss_cfg)
            mark("forward")
            (total / grad_accum).backward()
            mark("backward")
            for k, v in losses.items():
                total_losses[k] = total_losses.get(k, 0.0) + v.detach()
        # a trainable leaf the forward did not reach takes a zero gradient
        # (AdamW then still decays it, as the JAX optimizer does)
        for p in trainable:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        clip_detr_grads(model, clip_max_norm)
        mark("clip")
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        mark("adamw")
        return {k: v / grad_accum for k, v in total_losses.items()}

    return step
