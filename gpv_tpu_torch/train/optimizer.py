"""Optimizer: AdamW over the reference's parameter groups, with the
warmup-linear or multistep schedule (counterpart of
`gpv_tpu/train/optimizer.py`).

Reference `exp/gpv/train_distr.py:228-253`: AdamW groups detr_backbone
(lr_backbone 1e-5) / detr_head (lr) / others (lr), weight decay 1e-4; the
per-iteration `WarmupLinearSchedule` (`:293-305`); the gradient clip (0.1)
over the DETR groups alone as one global norm (`:423-426`).

Frozen parameters (`frozen` group, and DETR's under `training.freeze`)
get `requires_grad=False` and no optimizer group, so they are never
differentiated, decayed or updated:
  - `bert.*` (reference: no_grad + detach) and `answer_head.vocab_embed`;
  - the backbone stem, conv1 + layer1 (reference `backbone.py:61-63`);
  - `vision_token` / `lang_token` (never read by the forward);
  - `detr.*` under `training.freeze`, or exactly the checkpoint-loaded
    `frozen_detr_paths`.
Names are the reference torch names (`detr.backbone.0.body.layer2...`).
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch
from torch import nn

GROUPS = ("detr_backbone", "detr_head", "detr_joiner", "others")
DETR_GROUPS = ("detr_backbone", "detr_head", "detr_joiner")


def param_group(name: str) -> str:
    """The reference optimizer group of a parameter name."""
    keys = name.split(".")
    if name.startswith("detr.backbone.0.body."):
        # the reference Backbone freezes every body parameter without
        # layer2/3/4 in its name: conv1 and all of layer1
        return ("detr_backbone" if keys[4] in ("layer2", "layer3", "layer4")
                else "frozen")
    if name.startswith("detr.backbone."):
        # the learned 2-D position embedding (the Joiner's slot 1): backbone
        # lr group by name, but it trains
        return "detr_backbone"
    if keys[0] == "detr":
        return "detr_head"
    if keys[0] == "detr_joiner":
        # lr group 'detr_head' upstream (same lr and decay as 'others'),
        # clipped with DETR, but not frozen by training.freeze
        return "detr_joiner"
    if keys[0] in ("vision_token", "lang_token", "bert") \
            or name == "answer_head.vocab_embed":
        return "frozen"
    return "others"


def group_labels(model: nn.Module) -> Dict[str, str]:
    return {n: param_group(n) for n, _ in model.named_parameters()}


def frozen_names(model: nn.Module, freeze_detr: bool = False,
                 frozen_detr_paths: Optional[Iterable[str]] = None) -> set:
    """Names of the parameters that never train: the `frozen` group, and
    with `freeze_detr` every `detr.*` parameter or, given
    `frozen_detr_paths`, exactly those names."""
    paths = None if frozen_detr_paths is None else set(frozen_detr_paths)
    out = set()
    for name, label in group_labels(model).items():
        if label == "frozen":
            out.add(name)
        elif freeze_detr and name.startswith("detr.") and (
                paths is None or name in paths):
            out.add(name)
    return out


def warmup_linear_schedule(base_lr: float, total_steps: int,
                           warmup_fraction: float):
    """lr at optimizer update n (0-indexed) = base * lam(n + 1), lam being
    pytorch_transformers' WarmupLinearSchedule: the reference's LambdaLR
    steps once at construction, so its counter leads the update index by
    one. warmup_steps stays fractional, as upstream."""
    warmup = warmup_fraction * total_steps

    def schedule(step: int) -> float:
        n = float(step) + 1.0
        if n < warmup:
            return base_lr * n / max(warmup, 1.0)
        return base_lr * max((total_steps - n)
                             / max(total_steps - warmup, 1.0), 0.0)

    return schedule


def multistep_schedule(base_lr: float, milestones, gamma: float,
                       steps_per_epoch: int):
    """base_lr scaled by gamma at each milestone epoch's first update."""
    bounds = [int(m) * steps_per_epoch for m in milestones]

    def schedule(step: int) -> float:
        return base_lr * gamma ** sum(step >= b for b in bounds)

    return schedule


def make_schedule(training_cfg, steps_per_epoch: int):
    """The lr multiplier per update (base 1) the `training` node selects."""
    total_steps = steps_per_epoch * int(training_cfg.num_epochs)
    if training_cfg.lr_warmup and training_cfg.lr_linear_decay:
        return warmup_linear_schedule(
            1.0, total_steps, float(training_cfg.lr_warmup_fraction))
    return multistep_schedule(1.0, training_cfg.lr_milestones,
                              float(training_cfg.lr_drop), steps_per_epoch)


def build_optimizer(training_cfg, steps_per_epoch: int, model: nn.Module,
                    frozen_detr_paths: Optional[Iterable[str]] = None):
    """AdamW (betas 0.9/0.999, eps 1e-8, `training.weight_decay`) over the
    trainable parameters in their groups (`GROUPS`; detr_backbone at
    `lr_backbone`, the rest at `lr`), and a LambdaLR giving each update its
    scheduled lr. The parameters `frozen_names` gives for
    `training.freeze` and `frozen_detr_paths` (the names a DETR checkpoint
    loaded; None: all of DETR) are in no group. Returns (optimizer,
    scheduler)."""
    frozen = frozen_names(model, bool(training_cfg.get("freeze", False)),
                          frozen_detr_paths)
    lr, wd = float(training_cfg.lr), float(training_cfg.weight_decay)
    base = {"detr_backbone": float(training_cfg.lr_backbone)}
    params: Dict[str, list] = {g: [] for g in GROUPS}
    for name, p in model.named_parameters():
        if name not in frozen:
            params[param_group(name)].append(p)
    groups = [{"params": params[g], "lr": base.get(g, lr), "name": g}
              for g in GROUPS if params[g]]
    optimizer = torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=wd)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, make_schedule(training_cfg, steps_per_epoch))
    return optimizer, scheduler


def clip_detr_grads(model: nn.Module, max_norm: float) -> torch.Tensor:
    """Clip the DETR groups' gradients (backbone, head, joiner) by one
    global norm, as `clip_grad_norm_(detr_backbone + detr_head)` upstream
    (a true clip: scaled by min(1, max_norm / (norm + 1e-6))). Frozen
    parameters have no gradient and add nothing. Returns the norm."""
    grads = [p for n, p in model.named_parameters()
             if p.grad is not None and param_group(n) in DETR_GROUPS]
    if max_norm <= 0 or not grads:
        return torch.zeros(())
    return torch.nn.utils.clip_grad_norm_(grads, max_norm)
