"""Checkpoints: the trainer's own save and restore, and the loaders of the
pretrained DETR and ImageNet backbone (counterpart of
`gpv_tpu/train/checkpoint.py`).

Reference (`exp/gpv/train_distr.py:386-394`): one `torch.save` dict of the
model, optimizer, epoch, step and selection metric. Here a checkpoint is
one torch file `ckpt_dir/<name>` ("model" for the best, "last" for the
rolling one) holding the model's state dict, the optimizer's, the lr
schedule's, the step and each optimizer group's parameter names, with
`ckpt_dir/<name>.meta.json` beside it as the JAX package writes it. The
file is written under a temporary name and renamed into place, and the
meta is written last, so a write cut short leaves the previous checkpoint
whole.

The names let a run whose optimizer groups differ from the saved ones
resume: phase 2 of the two-phase recipe (`scripts/train.sh`) unfreezes the
DETR parameters that phase 1 left out of every group (`load_into`).

Not here: an orbax directory of the JAX package cannot be read without JAX
(ROADMAP Queue 1 item 19), and `training.async_checkpoint` is refused
(item 28).
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, List, Set, Tuple

import torch
from torch import nn

from ..weights import load_torch_state_dict


def param_names(state) -> Dict[str, List[str]]:
    """{optimizer group name: the names of its parameters, in the group's
    order} of a `TrainState`, as `build_optimizer` filled the groups."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    return {g["name"]: [names[id(p)] for p in g["params"]]
            for g in state.optimizer.param_groups}


def save_checkpoint(ckpt_dir: str | Path, state, metadata: Dict[str, Any],
                    name: str = "model") -> Path:
    """Write `state` (a `parallel.train_step.TrainState`) to
    ckpt_dir/name, then ckpt_dir/name.meta.json."""
    path = Path(ckpt_dir) / name
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{name}.writing")
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "scheduler": state.scheduler.state_dict(),
                "step": int(state.step),
                "param_names": param_names(state)}, tmp)
    os.replace(tmp, path)
    (path.parent / f"{name}.meta.json").write_text(
        json.dumps(metadata, default=float))
    return path


def restore_checkpoint(ckpt_dir: str | Path,
                       name: str = "model") -> Tuple[dict, dict]:
    """(payload, metadata) of ckpt_dir/name: the payload's tensors on the
    CPU, the metadata {} when its file is absent."""
    path = Path(ckpt_dir) / name
    if path.is_dir():
        raise NotImplementedError(
            f"{path} is a directory (an orbax checkpoint of the JAX "
            "package): gpv_tpu_torch cannot read orbax without JAX "
            "(ROADMAP Queue 1 item 19); resume from a checkpoint this "
            "package wrote or a reference .pth")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    meta_path = Path(ckpt_dir) / f"{name}.meta.json"
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    return payload, meta


def load_into(state, payload: dict) -> None:
    """Restore a `restore_checkpoint` payload into `state` in place.

    Saved optimizer groups that hold the parameters `state`'s hold (same
    names, same order): everything is restored as saved. Groups that
    differ (phase 2 resuming phase 1, whose frozen DETR parameters were in
    no group):
      - the model loads strictly and the step is restored;
      - AdamW's per-parameter state (exp_avg, exp_avg_sq, step) is carried
        by parameter name for every parameter that is in a group in both;
        a parameter that trains only now starts from empty state;
      - the groups keep this run's hyperparameters, and the LambdaLR is
        rebuilt at the restored step, so the next update takes the lr
        that this run's schedule gives at that step.
    A checkpoint without group names whose groups differ raises: its
    moments cannot be matched to parameters."""
    state.model.load_state_dict(payload["model"], strict=True)
    saved = payload["optimizer"]
    saved_names = payload.get("param_names")
    names = param_names(state)
    if saved_names is None:
        shape = [(g.get("name"), len(g["params"]))
                 for g in saved["param_groups"]]
        if shape != [(g, len(n)) for g, n in names.items()]:
            raise ValueError(
                f"the checkpoint's optimizer groups {shape} differ from this "
                f"run's {[(g, len(n)) for g, n in names.items()]} and it "
                "holds no parameter names (written before ROADMAP Queue 3 "
                "F1 was repaired), so its AdamW moments cannot be carried: "
                "resume it with the training.freeze it was written with")
        saved_names = names
    state.step = int(payload["step"])
    if saved_names == names:
        state.optimizer.load_state_dict(saved)
        state.scheduler.load_state_dict(payload["scheduler"])
        return
    by_name = {}
    for g in saved["param_groups"]:
        for i, n in zip(g["params"], saved_names[g["name"]]):
            if i in saved["state"]:
                by_name[n] = saved["state"][i]
    order = [n for g in names.values() for n in g]  # this run's indices
    fresh = state.optimizer.state_dict()
    fresh["state"] = {i: by_name[n] for i, n in enumerate(order)
                      if n in by_name}
    state.optimizer.load_state_dict(fresh)
    state.scheduler = torch.optim.lr_scheduler.LambdaLR(
        state.optimizer, state.scheduler.lr_lambdas,
        last_epoch=state.step - 1)


@torch.no_grad()
def _merge_matching(module: nn.Module, sd: Dict[str, torch.Tensor],
                    prefix: str = "") -> Set[str]:
    """Copy `sd` entries into `module`'s parameters and buffers where name
    and shape match (the reference's shape-checked partial load,
    `gpv.py:122-135`). Returns the names (with `prefix`) of the parameters
    copied; buffers (the frozen-BN statistics) load but are not listed."""
    params = dict(module.named_parameters())
    own = {**dict(module.named_buffers()), **params}
    matched = set()
    for key, value in sd.items():
        target = own.get(key)
        if target is not None and tuple(target.shape) == tuple(value.shape):
            target.copy_(torch.as_tensor(value, dtype=target.dtype))
            if key in params:
                matched.add(prefix + key)
    return matched


def load_pretr_detr(model: nn.Module, torch_path: str | Path) -> Set[str]:
    """DETR-only init (reference `GPV.load_pretr_detr`, gpv.py:122-135):
    copy a DETR checkpoint's entries into `model.detr` by name and shape,
    in place. Returns the `detr.*` parameter names that loaded (the
    reference's `init_detr_params`), which `training.freeze` freezes;
    parameters that did not load (absent or of another shape, such as
    `class_embed` under another num_classes) keep training."""
    return _merge_matching(model.detr, load_torch_state_dict(torch_path),
                           "detr.")


def load_imagenet_backbone(model: nn.Module, torch_path: str | Path) -> None:
    """Initialise only the ResNet trunk from a torchvision ImageNet state
    dict (`conv1.weight`, `layer1.0.downsample.0.weight`, ...; `fc.*` is
    left out), in place: the from-scratch recipe without a DETR checkpoint
    (reference `backbone.py:68`)."""
    _merge_matching(model.detr.trunk, load_torch_state_dict(torch_path))
