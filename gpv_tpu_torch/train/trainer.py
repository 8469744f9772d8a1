"""Multitask trainer, on one card or as one rank of a data-parallel group
(counterpart of `gpv_tpu/train/trainer.py`).

Reference `exp/gpv/train_distr.py`: per-epoch in-train eval of the
configured tasks, best-selection-metric checkpointing (the sum of VQA
accuracy, CIDEr, detection mAP and classification accuracy, :380-394),
scalars every `log_step`, HTML box visualisations every `vis_step`,
resume restoring step and epoch, and the two-phase frozen-DETR schedule
of `training.freeze`. `finetune` mode is `finetune_distr.py`: the
selection metric is refexp mAP, eval runs every `eval_every` epochs, and
resuming does not restore step or epoch (:268-278). A rolling `last`
checkpoint every `ckpt_step` steps, and `auto_resume` from it.

Two-phase resume (`scripts/train.sh`): phase 1 trains with
`training.freeze` and `model.pretr_detr`, so its frozen DETR parameters are
in no AdamW group; phase 2 resumes its `ckpts/model` with the freeze off.
`train.checkpoint.load_into` then loads the model strictly, restores the
step (and, here, the epoch), carries AdamW's moments and per-parameter
step by parameter name for every parameter that trained in phase 1,
starts the newly unfrozen parameters from empty state, and rebuilds the
lr schedule at the restored step. (The JAX package cannot resume this
step at all: its orbax restore refuses the changed optimizer tree.)

The model trains on the card unless `device` says otherwise
(`engine.resolve_device`). Parameters stay fp32; `tpu.dtype: bfloat16`
runs the forward under bf16 autocast; `tpu.remat` recomputes the backbone
stages, the DETR layers and the co-attention layers in the backward. In-train
eval and visualisation go through a `GPVEngine` that takes the current
weights each time (`GPVEngine.load_weights`: a folded copy; the training
model stays unfolded), over `tpu.infer_data_parallel` of the host's cards
(`infer.build.infer_devices`).

Data parallelism (`parallel.mesh`): one process per card, launched with
`python -m torch.distributed.run --nproc-per-node N -m
gpv_tpu_torch.cli.train ...` or with `tpu.distributed.*` set in each
process. Each rank loads its rows of every global batch
(`training.batch_size` stays global) and steps under DDP
(`parallel.train_step`); `tpu.mesh.data` is -1 or the number of processes
over `tpu.mesh.model`. As in the JAX trainer, rank 0 alone evaluates,
visualises, logs scalars and writes checkpoints (its in-train eval over
its own host's cards), and the ranks meet at host barriers after each
epoch's eval, each visualisation, each checkpoint and at the end; every
rank restores a resumed checkpoint. Frozen-BERT query dedup with more than
one data rank raises, as in the JAX trainer.

Tensor parallelism (`tpu.mesh.model` M > 1, one host: `torch.distributed.
run --nproc-per-node N ... tpu.mesh.model=M`): each model group of M
consecutive ranks shares one replica (`models.gpv.shard_params`) and takes
the same rows; the loaders shard by the data index. Saves gather the
whole state on rank 0's model group (`train.checkpoint`), so the files are
a model-1 trainer's; in-train eval and visualisation gather the whole
weights on that group too, ahead of the rank-0 branch, into a whole model
that rank 0's plain `GPVEngine` loads (`whole_model`, as the JAX
trainer's `_eval_variables`).

`training.async_checkpoint` writes both saves on a thread of their own
(`train.checkpoint`): every save in flight is joined before a loader forks
its workers (each epoch's loop, each in-train eval) and before `train()`
returns.
"""
from __future__ import annotations

import json
import time
import warnings
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from ..datasets.coco import CocoMultitaskDataset
from ..datasets.loader import Collator, DataLoader
from ..engine import GPVEngine, resolve_device
from ..infer.build import DTYPES, infer_devices
from ..losses.criterion import LossConfig
from ..models.gpv import build_gpv, shard_params
from ..parallel import mesh as mesh_lib
from ..parallel.sharding_rules import shard_state_dict
from ..parallel.tensor_parallel import gather_shards
from ..parallel.train_step import TrainState, make_train_step
from ..text.vocab import AnswerVocab
from ..text.wordpiece import WordPieceTokenizer
from ..utils.html_writer import HtmlWriter
from ..utils.profiling import StepTimer, start_trace, stop_trace
from ..utils.visualize import save_vis, vis_sample
from ..weights import init_random, load_torch_state_dict
from . import metrics as train_metrics
from .checkpoint import (load_imagenet_backbone, load_into, load_pretr_detr,
                         restore_checkpoint, save_checkpoint, wait_for_saves)
from .optimizer import build_optimizer


class Trainer:
    def __init__(self, cfg, finetune: bool = False):
        self.cfg = cfg
        self.finetune = finetune
        self.async_checkpoint = bool(cfg.training.get("async_checkpoint",
                                                      False))
        tpu = cfg.get("tpu") or {}
        # join the group before any card is touched; the mesh's checks
        # (data x model the world size) then hold for it
        cluster = mesh_lib.initialize_distributed(tpu, cfg.get("device"))
        self.mesh = mesh_lib.mesh_from_config(tpu)
        self.world, self.rank = mesh_lib.world_size(), \
            mesh_lib.process_index()
        self.is_main = self.rank == 0
        self.data_index = mesh_lib.groups().data_index
        self.tp = mesh_lib.model_group()
        self.device = resolve_device(mesh_lib.rank_device(cluster,
                                                          cfg.get("device")))
        name = str(cfg.tpu.dtype)
        if name not in DTYPES:
            raise ValueError(f"tpu.dtype={name!r}: one of {sorted(DTYPES)}")
        self.dtype = DTYPES[name]

        self.vocab = (AnswerVocab.load(cfg.model.vocab) if cfg.model.vocab
                      else AnswerVocab.debug())
        bert_vocab = cfg.model.get("bert_vocab")
        self.tokenizer = (WordPieceTokenizer.load(bert_vocab) if bert_vocab
                          else WordPieceTokenizer.debug())
        self.model = init_random(build_gpv(
            cfg.model, len(self.vocab), remat=bool(tpu.get("remat"))), 0)

        self.datasets = {
            subset: CocoMultitaskDataset(cfg.learning_datasets,
                                         cfg.task_configs, subset,
                                         training=(subset == "train"))
            for subset in ("train", "val")}
        self.collator = Collator(
            self.vocab, self.tokenizer,
            max_text_len=int(cfg.model.max_text_len),
            max_target_boxes=int(cfg.model.get("max_target_boxes", 64)),
            answering_type=str(cfg.model.answering_type),
            dedup_queries=bool(cfg.training.get("query_dedup", False)))
        if self.collator.dedup_queries and self.mesh.data > 1:
            # data ranks' unique-query counts differ (gpv_tpu trainer:
            # 106-113); the ranks of one model group hold the same rows
            raise ValueError(
                f"training.query_dedup=true with tpu.mesh.data="
                f"{self.mesh.data}: dedup needs every rank to hold the same "
                "rows, as the JAX trainer requires a single host process "
                "(per-host unique-query buckets cannot be made consistent "
                "across a sharded loader); unset it or use tpu.mesh.data=1")
        grad_accum = int(cfg.training.get("grad_accum_steps", 1))
        freeze = bool(cfg.training.get("freeze", False))
        batch_size = int(cfg.training.batch_size)
        if freeze:
            # the frozen phase trains at its own batch (reference
            # train_distr.py:485-486)
            batch_size = int(cfg.training.get("frozen_batch_size",
                                              batch_size))
        self.loaders = {
            s: DataLoader(d, self.collator, batch_size,
                          shuffle=(s == "train"),
                          num_workers=int(cfg.training.num_workers), seed=0,
                          num_shards=self.mesh.data,
                          shard_id=self.data_index,
                          grad_accum=grad_accum if s == "train" else 1)
            for s, d in self.datasets.items()}

        if cfg.model.vocab_embed:
            with torch.no_grad():
                self.model.answer_head.vocab_embed.copy_(torch.from_numpy(
                    np.load(cfg.model.vocab_embed).astype(np.float32)))
        matched_detr = None  # reference init_detr_params
        if cfg.model.pretr_detr:
            matched_detr = load_pretr_detr(self.model, cfg.model.pretr_detr)
        elif cfg.model.get("pretr_backbone"):
            load_imagenet_backbone(self.model, cfg.model.pretr_backbone)
        if freeze and matched_detr is not None:
            n_detr = sum(1 for n, _ in self.model.named_parameters()
                         if n.startswith("detr."))
            if len(matched_detr) < n_detr:
                warnings.warn(
                    f"training.freeze: only {len(matched_detr)}/{n_detr} "
                    "detr params were initialized from "
                    f"{cfg.model.pretr_detr}; the rest keep training "
                    "(reference freezes only loaded keys)", RuntimeWarning)
        elif freeze:
            warnings.warn(
                "training.freeze without model.pretr_detr: the reference "
                "freezes only checkpoint-loaded DETR params, so nothing "
                "would be frozen upstream; freezing the randomly-"
                "initialized detr subtree anyway", RuntimeWarning)

        self.model.to(self.device)
        # rank 0 evaluates over its host's cards; the other ranks never
        # predict, and hold their engine on their own card
        devices = infer_devices(tpu.get("infer_data_parallel", 1),
                                self.device)
        self.engine = GPVEngine(self.model, self.vocab, self.tokenizer,
                                dtype=self.dtype, devices=(
                                    devices if self.is_main
                                    else [self.device]))
        self._whole = None  # rank 0's whole model for eval under TP
        if self.tp is not None:
            if self.is_main:
                self._whole = build_gpv(cfg.model, len(self.vocab))
            shard_params(self.model, self.tp)
        steps_per_epoch = max(len(self.loaders["train"]), 1)
        optimizer, scheduler = build_optimizer(
            cfg.training, steps_per_epoch, self.model,
            frozen_detr_paths=matched_detr)
        self.state = TrainState(self.model, optimizer, scheduler)
        self.train_step = make_train_step(
            self.model, LossConfig.from_config(cfg.losses),
            float(cfg.training.clip_max_norm), grad_accum=grad_accum,
            freeze_detr=freeze, frozen_detr_paths=matched_detr,
            dtype=self.dtype)

        self.step = 0
        self.last_epoch = -1
        self.best_metric = 0.0
        self.best_epoch = -1

        self.writer = None
        if cfg.get("tb_dir") and self.is_main:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.writer = SummaryWriter(log_dir=str(cfg.tb_dir))
            except Exception as e:  # a run without scalars must say so
                warnings.warn(
                    f"TensorBoard logging DISABLED: tb_dir={cfg.tb_dir!r} "
                    f"was requested but the writer failed to initialize "
                    f"({type(e).__name__}: {e}); training continues without "
                    "scalars", RuntimeWarning, stacklevel=2)

        last = Path(cfg.ckpt_dir) / "last"
        if cfg.training.get("ckpt"):
            self._resume(cfg.training.ckpt)
        elif cfg.training.get("auto_resume") and last.exists():
            print(f"auto_resume: restoring {last}")
            self._resume(last)
            # the rolling checkpoint's meta has no selection metric: take
            # the best one's, or the next eval would overwrite 'model'
            best_meta = Path(cfg.ckpt_dir) / "model.meta.json"
            if best_meta.exists():
                m = json.loads(best_meta.read_text())
                self.best_metric = float(
                    m.get("model_selection_metric", self.best_metric))
                self.best_epoch = int(m.get("epoch", self.best_epoch))

    # ------------------------------------------------------------------

    def _resume(self, ckpt_path):
        ckpt_path = Path(ckpt_path)
        if ckpt_path.suffix == ".pth":  # released reference weights
            sd = load_torch_state_dict(ckpt_path)
            if self.tp is not None:
                sd = shard_state_dict(sd, self.model.tp_rules.specs,
                                      self.tp.rank, self.tp.size)
            self.model.load_state_dict(sd, strict=True)
            return
        payload, meta = restore_checkpoint(ckpt_path.parent, ckpt_path.name)
        load_into(self.state, payload)
        if not self.finetune:
            # finetune_distr deliberately does not restore step/epoch
            self.step = int(payload["step"])
            self.last_epoch = int(meta.get("epoch", -1))
        self.best_metric = float(meta.get("model_selection_metric", 0.0))
        self.best_epoch = int(meta.get("epoch", -1))

    # ------------------------------------------------------------------

    def whole_model(self):
        """The model whose weights the engine serves: the training model,
        or under tensor parallelism, on rank 0, a whole model holding the
        weights gathered over its model group (None on the other ranks).
        Every rank calls it: the gather is a collective."""
        if self.tp is None:
            return self.model
        if self.data_index != 0:
            return None
        whole = gather_shards(self.model.state_dict(),
                              self.model.tp_rules.specs, self.tp)
        if not self.is_main:
            return None
        self._whole.load_state_dict(whole, strict=True)
        return self._whole

    def evaluate(self, subset: str = "val", model=None) -> Dict[str, float]:
        """In-train eval over the configured tasks: metric dict with the
        selection metric (reference :327-385). `model`: `whole_model()`'s
        (the training model when None, which must then be whole)."""
        cfg = self.cfg
        self.engine.load_weights(self._served(model))
        nvs = cfg.training.num_val_samples
        eval_bs = int(cfg.eval.batch_size)
        nw = int(cfg.eval.get("num_workers", 8))
        results: Dict[str, float] = {}
        selection = 0.0
        ds = CocoMultitaskDataset(cfg.learning_datasets, cfg.task_configs,
                                  subset, training=False)
        for name, sub in zip(ds.names, ds.datasets):
            if name == "CocoVqa":
                acc = train_metrics.vqa_accuracy(
                    self.engine, sub, eval_bs, int(nvs.get("coco_vqa", 1000)),
                    num_workers=nw)
                results["vqa_acc"] = acc
                selection += acc
            elif name == "CocoCaptioning":
                scores = train_metrics.cap_metrics(
                    self.engine, sub, eval_bs, int(nvs.get("coco_cap", 1000)),
                    num_workers=nw)
                results["cider"] = float(scores.get("Cider", 0.0))
                results["bleu4"] = float(scores.get("Bleu4", 0.0))
                selection += results["cider"]
            elif name == "CocoClassification":
                m = train_metrics.cls_metrics(
                    self.engine, sub, eval_bs, int(nvs.get("coco_cls", 1000)),
                    num_workers=nw)
                results["cls_acc"] = m["accuracy"]
                selection += m["accuracy"]
            elif name == "CocoDetection":
                m = train_metrics.det_metrics(
                    self.engine, sub, eval_bs, int(nvs.get("coco_det", 1000)),
                    num_workers=nw)
                results["det_map"] = m["mAP"]
                selection += m["mAP"]
            elif name == "RefCocop":
                m = train_metrics.refexp_metrics(
                    self.engine, sub, eval_bs,
                    int(nvs.get("refcocop", 1000)), num_workers=nw)
                results["refexp_map"] = m["mAP"]
                selection += m["mAP"]
        if self.finetune:
            selection = results.get("refexp_map", 0.0)
        results["model_selection_metric"] = selection
        return results

    def _served(self, model):
        if model is None and self.tp is not None:
            raise ValueError("the training model is sharded: pass "
                             "whole_model()'s, gathered on every rank")
        return self.model if model is None else model

    def visualize(self, subset: str, step: int, model=None):
        """HTML dump of predictions against GT (reference visualize(),
        :40-133); `model` as in `evaluate`."""
        cfg = self.cfg
        self.engine.load_weights(self._served(model))
        vis_dir = (Path(cfg.exp_dir) / "training_visualizations"
                   / f"{subset}_{step}")
        vis_dir.mkdir(parents=True, exist_ok=True)
        ds = self.datasets[subset]
        rng = np.random.RandomState(step)
        n = min(int(cfg.training.num_vis_samples), len(ds))
        idxs = rng.choice(len(ds), size=n, replace=False)
        items = [ds.get(int(i), rng) for i in idxs]
        outs = self.engine.predict(np.stack([it["image"] for it in items]),
                                   [it["query"] for it in items])
        html = HtmlWriter(vis_dir / "index.html")
        html.add_row(["query", "gt answer", "pred answer", "image"])
        for i, (it, out) in enumerate(zip(items, outs)):
            img = vis_sample(it["image"], out["boxes"], out["relevance"],
                             it.get("boxes"), answer=out["answer"])
            save_vis(img, vis_dir / f"{i}.jpg")
            html.add_row([it["query"], it.get("answer", ""), out["answer"],
                          html.image_tag(f"{i}.jpg")])
        html.close()

    def save(self, epoch: int, results: Dict[str, float]):
        """The best checkpoint `model` (rank 0 writes; every rank calls)."""
        meta = {"epoch": epoch, "step": self.step,
                "model_selection_metric":
                    results.get("model_selection_metric", 0.0)}
        meta.update(results)
        save_checkpoint(self.cfg.ckpt_dir, self.state, meta,
                        async_write=self.async_checkpoint)

    def save_last(self, epoch: int):
        """The rolling checkpoint `last`, for preemption recovery (rank 0
        writes; every rank calls)."""
        save_checkpoint(self.cfg.ckpt_dir, self.state,
                        {"epoch": epoch, "step": self.step}, name="last",
                        async_write=self.async_checkpoint)

    # ------------------------------------------------------------------

    def _eval_and_save(self, epoch: int, final: bool = False):
        """Rank 0 evaluates; every rank learns whether the selection
        metric improved and, if so, takes part in the save."""
        results = {}
        whole = self.whole_model()  # every rank, before the rank-0 branch
        if self.is_main:
            wait_for_saves()  # before the eval's loader forks
            results = self.evaluate("val", whole)
            if self.writer and not final:
                for k, v in results.items():
                    self.writer.add_scalar(f"val/{k}", v, self.step)
            if not final:
                print(f"epoch {epoch} eval: {results}")
        better = mesh_lib.broadcast_from_main(
            self.is_main and (results["model_selection_metric"]
                              > self.best_metric or self.best_epoch < 0))
        if better:
            if not final:
                self.best_metric = results.get("model_selection_metric",
                                               0.0)
                self.best_epoch = epoch
            self.save(epoch, results)
        return results

    def train(self):
        cfg = self.cfg
        num_epochs = int(cfg.training.num_epochs)
        if cfg.training.get("freeze"):
            num_epochs = int(cfg.training.frozen_epochs)
        eval_every = int(cfg.training.get("eval_every", 1))
        launch = True
        for epoch in range(self.last_epoch + 1, num_epochs):
            run_eval = (epoch % eval_every == 0) or (epoch == num_epochs - 1)
            if run_eval and (not launch
                             or cfg.training.get("run_eval_at_launch", True)):
                self._eval_and_save(epoch)
            if launch and cfg.training.get("run_vis_at_launch", True):
                whole = self.whole_model()  # every rank
                if self.is_main:
                    self.visualize("train", self.step, whole)
            launch = False
            # the ranks meet after rank 0's eval and visualisation (the
            # JAX trainer's _sync): a gloo barrier whose timeout is
            # tpu.distributed.barrier_timeout_min, as they may take long
            mesh_lib.host_barrier()

            loader = self.loaders["train"]
            loader.set_epoch(epoch)
            timer = StepTimer()
            t0 = time.time()
            profile_step = cfg.training.get("profile_step")
            trace_dir = cfg.get("tb_dir") or Path(cfg.exp_dir) / "tb_logs"
            prof = None
            wait_for_saves()  # before the loader forks its workers
            for it, batch in enumerate(loader):
                timer.tick()
                if profile_step is not None and self.is_main:
                    if self.step == int(profile_step):
                        prof = start_trace()
                    elif prof is not None \
                            and self.step == int(profile_step) + 3:
                        stop_trace(prof, trace_dir)
                        prof = None
                losses = self.train_step(self.state, batch)
                self.step += 1
                if self.step % int(cfg.training.log_step) == 0 \
                        and self.is_main:
                    tl = float(losses["total_loss"])
                    dt = time.time() - t0
                    print(f"epoch {epoch} it {it} step {self.step} "
                          f"loss {tl:.4f} ({dt / (it + 1):.2f}s/it)")
                    if self.writer:
                        for k, v in losses.items():
                            self.writer.add_scalar(f"train/{k}", float(v),
                                                   self.step)
                        self.writer.add_scalar("train/steps_per_sec",
                                               timer.steps_per_sec(),
                                               self.step)
                if self.step % int(cfg.training.vis_step) == 0:
                    whole = self.whole_model()  # every rank
                    if self.is_main:
                        self.visualize("train", self.step, whole)
                    mesh_lib.host_barrier()
                if self.step % int(cfg.training.ckpt_step) == 0:
                    self.save_last(epoch)  # a barrier follows the save
            if prof is not None:
                stop_trace(prof, trace_dir)

        wait_for_saves()
        results = self._eval_and_save(num_epochs - 1, final=True)
        wait_for_saves()  # every write lands before the run returns
        mesh_lib.host_barrier()
        return results
