"""Checkpoints: the trainer's own save and restore, and the loaders of the
pretrained DETR and ImageNet backbone (counterpart of
`gpv_tpu/train/checkpoint.py`).

Reference (`exp/gpv/train_distr.py:386-394`): one `torch.save` dict of the
model, optimizer, epoch, step and selection metric. Here a checkpoint is
one torch file `ckpt_dir/<name>` ("model" for the best, "last" for the
rolling one) holding the model's state dict, the optimizer's, the lr
schedule's and the step, with `ckpt_dir/<name>.meta.json` beside it as the
JAX package writes it. The file is written under a temporary name and
renamed into place, and the meta is written last, so a write cut short
leaves the previous checkpoint whole.

Not here: an orbax directory of the JAX package cannot be read without JAX
(ROADMAP Queue 1 item 19), and `training.async_checkpoint` is refused
(item 28).
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Set, Tuple

import torch
from torch import nn

from ..weights import load_torch_state_dict


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
                "step": int(state.step)}, tmp)
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
    """Restore a `restore_checkpoint` payload into `state` in place."""
    state.model.load_state_dict(payload["model"], strict=True)
    state.optimizer.load_state_dict(payload["optimizer"])
    state.scheduler.load_state_dict(payload["scheduler"])
    state.step = int(payload["step"])


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
