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

Async saves (`training.async_checkpoint`, `save_checkpoint(...,
async_write=True)`), with the semantics of the JAX package's:
  - The AdamW here updates parameters, moments and steps in place, so the
    writer never holds a live tensor: before `save_checkpoint` returns,
    every tensor of the model's, the optimizer's and the schedule's state
    is copied into host buffers (pinned for a card's tensors), kept per
    path and reused by its next save. Only the disk write (`torch.save` to
    `.<name>.writing`, the rename, then the meta) runs on the writer thread.
  - A save or restore on a path first joins the save in flight on it;
    saves under different names write at once. `wait_for_saves()` joins
    them all. A failed write raises at its join, leaves the previous
    checkpoint whole and is dropped, so later saves go on.
  - Fork rule: a fork while the writer thread holds a lock could leave
    that lock held in the child, so the trainer joins every save in flight
    before a loader forks its workers (each epoch's loop, each in-train
    eval). Only the rolling `last` saves inside an epoch overlap steps.

In a data-parallel group (`parallel.mesh`) rank 0 writes, sync or async,
and every rank waits at a host barrier after each save, so no rank forks a
loader or reads the file before rank 0 has issued its write; every rank
restores on its own.

Under tensor parallelism (`models.gpv.shard_params`) the file is the one a
model-1 trainer writes, the same names and whole shapes, as the JAX
package saves full host arrays: before rank 0 writes, the ranks of its
model group gather the sharded parameters and their AdamW `exp_avg` /
`exp_avg_sq` (`parallel.tensor_parallel.gather_shards`; every rank
calls `save_checkpoint`, ahead of any branch on the rank). `load_into`
takes each rank's slices of a whole payload, so a checkpoint moves
between topologies.

An orbax directory of the JAX package is read once converted
(`convert_orbax_checkpoint.py` at the repository root, where JAX is
installed). Its output holds no schedule state: `load_into` then keeps this
run's schedule at the restored step, as the JAX package resumes.
"""
from __future__ import annotations

import copy
import json
import os
import threading
from pathlib import Path
from typing import Any, Dict, List, Set, Tuple

import torch
from torch import nn

from ..parallel import mesh
from ..parallel.sharding_rules import shard_state_dict, shard_tensor
from ..parallel.tensor_parallel import gather_shard, gather_shards
from ..weights import load_torch_state_dict, orbax_refusal

_MOMENTS = ("exp_avg", "exp_avg_sq")  # AdamW's per-parameter tensors

# async saves in flight: resolved path -> (writer thread, its outcome)
_INFLIGHT: Dict[str, Tuple[threading.Thread, dict]] = {}
_INFLIGHT_LOCK = threading.Lock()
# per path: the host buffers of its last async save, reused by the next
_BUFFERS: Dict[str, Dict[str, torch.Tensor]] = {}


def param_names(state) -> Dict[str, List[str]]:
    """{optimizer group name: the names of its parameters, in the group's
    order} of a `TrainState`, as `build_optimizer` filled the groups."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    return {g["name"]: [names[id(p)] for p in g["params"]]
            for g in state.optimizer.param_groups}


def wait_for_saves(path=None) -> None:
    """Join the async saves in flight: all of them (path None), or the one
    on `path`. A failed write raises here, once: its entry is dropped
    either way, and the previous checkpoint at its path is untouched."""
    with _INFLIGHT_LOCK:
        if path is None:
            pending = list(_INFLIGHT.items())
        else:
            key = str(Path(path).resolve())
            pending = [(key, _INFLIGHT[key])] if key in _INFLIGHT else []
    for key, entry in pending:
        thread, outcome = entry
        try:
            thread.join()
            if "error" in outcome:
                raise outcome["error"]
        finally:
            with _INFLIGHT_LOCK:
                if _INFLIGHT.get(key) is entry:
                    del _INFLIGHT[key]


def _host_copy(obj, key: str, buffers: Dict[str, torch.Tensor]):
    """`obj` with every tensor copied into `buffers[<its key>]` (made or
    remade when absent or of another shape; pinned for a card's tensor),
    and every other value deep-copied."""
    if isinstance(obj, torch.Tensor):
        buf = buffers.get(key)
        if buf is None or buf.shape != obj.shape or buf.dtype != obj.dtype:
            buf = torch.empty(obj.shape, dtype=obj.dtype,
                              pin_memory=obj.is_cuda)
            buffers[key] = buf
        buf.copy_(obj.detach(), non_blocking=obj.is_cuda)
        return buf
    if isinstance(obj, dict):
        return {k: _host_copy(v, f"{key}/{k}", buffers)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v, f"{key}/{i}", buffers)
                         for i, v in enumerate(obj))
    return copy.deepcopy(obj)


def _write(payload: dict, path: Path, metadata: Dict[str, Any]) -> None:
    """The payload to `.<name>.writing`, renamed into place, then the
    meta: a write cut short leaves the previous checkpoint whole."""
    tmp = path.with_name(f".{path.name}.writing")
    torch.save(payload, tmp)
    os.replace(tmp, path)
    (path.parent / f"{path.name}.meta.json").write_text(
        json.dumps(metadata, default=float))


def save_checkpoint(ckpt_dir: str | Path, state, metadata: Dict[str, Any],
                    name: str = "model", async_write: bool = False) -> Path:
    """Write `state` (a `parallel.train_step.TrainState`; its scheduler may
    be None) to ckpt_dir/name, then ckpt_dir/name.meta.json. With
    `async_write` the state is first copied to host buffers and the write
    runs on a thread of its own; join it with `wait_for_saves` (module
    docstring). In a process group only rank 0 writes, and every rank
    then waits at `mesh.host_barrier`; under tensor parallelism the ranks
    of rank 0's model group first gather the whole state."""
    path = Path(ckpt_dir).resolve() / name
    tp = getattr(state.model, "tp", None)
    payload = None
    if tp is not None and mesh.groups().data_index == 0:
        payload = _payload(state)  # a collective over the model group
    if mesh.is_main():
        _save(path, payload or _payload(state), metadata, async_write)
    mesh.host_barrier()
    return path


def _moment_names(optimizer_sd: dict, names: Dict[str, List[str]]) -> dict:
    """{state index: parameter name} of an optimizer state dict whose
    groups hold `names` ({group name: names in order})."""
    return {i: n for g in optimizer_sd["param_groups"]
            for i, n in zip(g["params"], names[g["name"]])}


def _payload(state) -> dict:
    """What a checkpoint holds; a sharded model's whole, gathered over its
    model group (every rank of the group must call it)."""
    names = param_names(state)
    model_sd = state.model.state_dict()
    optimizer = state.optimizer.state_dict()
    tp = getattr(state.model, "tp", None)
    if tp is not None:
        specs = state.model.tp_rules.specs
        model_sd = gather_shards(model_sd, specs, tp)
        owner = _moment_names(optimizer, names)
        optimizer = dict(optimizer, state={
            i: {k: (gather_shard(v, specs[owner[i]].full_shape,
                                 specs[owner[i]].dim,
                                 specs[owner[i]].chunks, tp)
                    if k in _MOMENTS and owner[i] in specs else v)
                for k, v in st.items()}
            for i, st in optimizer["state"].items()})
    return {"model": model_sd,
            "optimizer": optimizer,
            "scheduler": (state.scheduler.state_dict()
                          if state.scheduler is not None else None),
            "step": int(state.step),
            "param_names": names}


def _save(path: Path, payload: dict, metadata: Dict[str, Any],
          async_write: bool) -> None:
    wait_for_saves(path)  # never two writers on one path
    path.parent.mkdir(parents=True, exist_ok=True)
    if not async_write:
        _write(payload, path, dict(metadata))
        return
    payload = _host_copy(payload, "", _BUFFERS.setdefault(str(path), {}))
    if torch.cuda.is_available():
        torch.cuda.synchronize()  # the copies land before a step can run
    outcome: dict = {}

    def run():
        try:
            _write(payload, path, dict(metadata))
        except BaseException as e:  # raised again at the join
            outcome["error"] = e
    thread = threading.Thread(target=run, name=f"save {path.name}")
    with _INFLIGHT_LOCK:
        _INFLIGHT[str(path)] = (thread, outcome)
    thread.start()


def restore_checkpoint(ckpt_dir: str | Path,
                       name: str = "model") -> Tuple[dict, dict]:
    """(payload, metadata) of ckpt_dir/name: the payload's tensors on the
    CPU, the metadata {} when its file is absent."""
    path = Path(ckpt_dir) / name
    wait_for_saves(path)  # a save just issued lands first
    if path.is_dir():
        raise NotImplementedError(orbax_refusal(path))
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
    A checkpoint without schedule state (`convert_orbax_checkpoint.py`'s)
    takes the second way whatever its groups: this run's hyperparameters
    and schedule at the restored step, as the JAX package resumes. A
    checkpoint without group names whose groups differ raises: its moments
    cannot be matched to parameters. A model sharded for tensor
    parallelism takes its slices of the whole payload first."""
    names = param_names(state)
    if getattr(state.model, "tp", None) is not None:
        payload = _shard_payload(payload, state.model, names)
    state.model.load_state_dict(payload["model"], strict=True)
    saved = payload["optimizer"]
    saved_names = payload.get("param_names")
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
    if saved_names == names and payload.get("scheduler") is not None:
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


def _shard_payload(payload: dict, model: nn.Module,
                   names: Dict[str, List[str]]) -> dict:
    """A whole payload -> this rank's: the sharded parameters and their
    AdamW moments sliced (`models.gpv.shard_params`)."""
    specs, tp = model.tp_rules.specs, model.tp
    saved = payload["optimizer"]
    owner = _moment_names(saved, payload.get("param_names") or names)

    def local(i, k, v):
        spec = specs.get(owner.get(i))
        if k not in _MOMENTS or spec is None:
            return v
        return shard_tensor(v, spec.dim, spec.chunks, tp.rank, tp.size)
    return dict(payload, model=shard_state_dict(payload["model"], specs,
                                                tp.rank, tp.size),
                optimizer=dict(saved, state={
                    i: {k: local(i, k, v) for k, v in st.items()}
                    for i, st in saved["state"].items()}))


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
