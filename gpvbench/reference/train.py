"""GPV-1's multitask training step written out in plain PyTorch: the
yardstick of the training cell.

One step over a batch of the four COCO tasks, as allenai/gpv-1's
`train_distr.py` runs it: the teacher-forced forward (`gpv.encode` and
`gpv.answer_logits`, BERT frozen), the GPV criterion (per task
text cross-entropy for captioning, VQA and classification; DETR's
localization losses over a Hungarian matching solved by scipy), the
backward, the gradient clip over the DETR groups, and AdamW with the
warmup-linear schedule. The arithmetic is fp32 (TF32 off) or, for the
control, float8 (`gpv.Precision`).

Which parameters train follows the published rules: BERT, the vocabulary
embedding, the two unused tokens and the backbone's stem and layer1 are
frozen; DETR's backbone (layers 2-4) trains at `lr_backbone`, the rest at
`lr`; the clip covers DETR and its joiner.

Dropout is off (the configuration's rates are 0): its masks are random
draws inside the program that no stated interface shows, so the reference
could only follow them from the program's internals. Everything it
computes comes from the batch's raw items.

The forward runs in blocks of rows; every normaliser (the longest answer,
each task's sample count, the boxes, the weighted cross-entropy's
denominator) is taken over the whole batch first, so the blocks' losses
add up to the batch's.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from . import gpv

TASKS = {"CocoCaptioning": 0, "CocoVqa": 1, "CocoClassification": 2,
         "CocoDetection": 3}
TEXT_LOSSES = (("CocoCaptioning", "loss_caption", "CaptionLoss"),
               ("CocoVqa", "loss_vqa", "VqaLoss"),
               ("CocoClassification", "loss_cls", "ClsLoss"))
LOC_LOSSES = ("loss_ce", "loss_bbox", "loss_giou")
BETAS, EPS = (0.9, 0.999), 1e-8


def trainable(name: str, kind: str) -> bool:
    if kind.startswith("bn_"):         # frozen BatchNorm statistics
        return False
    if name.startswith("detr.backbone.0.body."):
        return name.split(".")[4] in ("layer2", "layer3", "layer4")
    return not (name.startswith("bert.") or name in (
        "answer_head.vocab_embed", "vision_token", "lang_token"))


def clipped(name: str) -> bool:
    return name.startswith(("detr.", "detr_joiner."))


def lr_multiplier(update: int, total: int, warmup_fraction: float) -> float:
    """pytorch_transformers' WarmupLinearSchedule at update `update`
    (0-based; the schedule's counter leads it by one)."""
    warmup = warmup_fraction * total
    n = update + 1.0
    if n < warmup:
        return n / max(warmup, 1.0)
    return max((total - n) / max(total - warmup, 1.0), 0.0)


# --------------------------------------------------------------- boxes

def xyxy(b):
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def giou(a, b):
    """Generalized IoU of every pair of xyxy boxes: (N,4), (M,4) -> (N,M)."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    union = area_a[:, None] + area_b[None] - inter
    iou = inter / union.clamp(min=1e-9)
    lt = torch.minimum(a[:, None, :2], b[None, :, :2])
    rb = torch.maximum(a[:, None, 2:], b[None, :, 2:])
    hull = (rb - lt).clamp(min=0).prod(-1)
    return iou - (hull - union) / hull.clamp(min=1e-9)


def match_cost(logits, boxes, tgt, costs) -> torch.Tensor:
    """DETR's matching cost of one image's targets (M,4) against its
    queries: (M, Q), the class cost on class 0 (GPV's one class)."""
    prob = logits.softmax(-1)[:, 0]                            # (Q,)
    c_bbox = (tgt[:, None, :] - boxes[None]).abs().sum(-1)
    c_giou = -giou(xyxy(tgt), xyxy(boxes))
    return (costs["bbox"] * c_bbox - costs["ce"] * prob[None]
            + costs["giou"] * c_giou)


def solve(cost: torch.Tensor) -> np.ndarray:
    from scipy.optimize import linear_sum_assignment
    rows, cols = linear_sum_assignment(cost.detach().cpu().double().numpy())
    return cols[np.argsort(rows)]


# ----------------------------------------------------------------- data

def encode_answer(index: Dict[str, int], answer, length: int):
    """`__cls__ words __stop__`, padded with `__pad__` -> (ids, length)."""
    toks = ["__cls__"] + (answer.split() if answer else []) + ["__stop__"]
    toks = toks[:length]
    ids = [index[t] for t in toks] + [index["__pad__"]] * (length - len(toks))
    return ids, len(toks)


def batch_tensors(items: List[dict], answer_words, bert_words,
                  query_len: int, text_len: int, device) -> dict:
    """The reference's own tensors of a batch of raw items."""
    index = {w: i for i, w in enumerate(answer_words)}
    ids, valid = gpv.tokenize(bert_words, [it["query"] for it in items],
                              query_len)
    enc = [encode_answer(index, it.get("answer"), text_len) for it in items]
    return {
        "image": torch.from_numpy(np.stack([it["image"] for it in items])),
        "query_ids": ids, "query_valid": valid,
        "answer_ids": torch.tensor([e[0] for e in enc]),
        "answer_lens": torch.tensor([e[1] for e in enc]),
        "task": torch.tensor([TASKS[it["task"]] for it in items]),
        "has_answer": torch.tensor(["answer" in it for it in items]),
        "boxes": [torch.tensor(np.asarray(it.get("boxes", np.zeros((0, 4))),
                                          np.float32).reshape(-1, 4))
                  for it in items]}


# ----------------------------------------------------------------- step

def step_losses(P, W, model, losses_cfg, batch, device, block: int,
                backward: bool = True):
    """The losses of one batch, and (with `backward`) their gradients
    accumulated into W's leaves: {loss name: value}."""
    B = batch["query_ids"].shape[0]
    Q = int(model["detr"]["num_queries"])
    has = batch["has_answer"]
    smax = int(batch["answer_lens"][has].max()) if has.any() else 0
    counts = {t: float(((batch["task"] == TASKS[t]) & has).sum())
              for t, _, _ in TEXT_LOSSES}
    nb = torch.tensor([len(b) for b in batch["boxes"]])
    with_boxes = nb > 0
    num_boxes = max(float(nb.sum()), 1.0)
    eos = float(losses_cfg["Localization"]["eos_coef"])
    w_total = float((nb + eos * (Q - nb))[with_boxes].sum())
    costs = losses_cfg["Localization"]["cost_wts"]
    wts = {name: float(losses_cfg[node]["loss_wts"][name])
           for _, name, node in TEXT_LOSSES}
    wts.update({k: float(v) for k, v in
                losses_cfg["Localization"]["loss_wts"].items()})
    total = {k: 0.0 for k in list(wts)}
    for s in range(0, B, block):
        rows = slice(s, min(s + block, B))
        img = batch["image"][rows].to(device)
        e = gpv.encode(P, W, model, img, batch["query_ids"][rows].to(device),
                       batch["query_valid"][rows].to(device))
        aid = batch["answer_ids"][rows].to(device)
        lg = gpv.answer_logits(P, W, model, e["memory"], e["mem_valid"],
                               aid)[:, :-1]
        ce = torch.logsumexp(lg, -1) - lg.gather(
            -1, aid[:, 1:, None])[..., 0]
        keep = torch.arange(ce.shape[1], device=device)[None] < smax - 1
        per = (ce * keep).sum(1)
        part = {}
        task = batch["task"][rows].to(device)
        hr = has[rows].to(device)
        for t, name, _ in TEXT_LOSSES:
            m = (task == TASKS[t]) & hr
            part[name] = (per * m).sum() / max(counts[t], 1.0)
        l_ce = l_bbox = l_giou = torch.zeros((), device=device)
        for j, r in enumerate(range(rows.start, rows.stop)):
            tgt = batch["boxes"][r].to(device)
            logp = e["logits"][j].log_softmax(-1)
            if len(tgt) == 0:
                continue
            cost = match_cost(e["logits"][j], e["boxes"][j], tgt, costs)
            q = torch.from_numpy(solve(cost)).to(device)
            cls = torch.full((Q,), logp.shape[-1] - 1, device=device)
            cls[q] = 0
            w = torch.where(cls == 0, 1.0, eos)
            l_ce = l_ce - (w * logp.gather(1, cls[:, None])[:, 0]).sum()
            src = e["boxes"][j][q]
            l_bbox = l_bbox + (src - tgt).abs().sum()
            l_giou = l_giou + (1 - torch.diagonal(giou(xyxy(src),
                                                      xyxy(tgt)))).sum()
        part["loss_ce"] = l_ce / max(w_total, 1.0)
        part["loss_bbox"] = l_bbox / num_boxes
        part["loss_giou"] = l_giou / num_boxes
        loss = sum(wts[k] * v for k, v in part.items()
                   if k in LOC_LOSSES or counts[
                       next(t for t, n, _ in TEXT_LOSSES if n == k)] > 0)
        if backward:
            loss.backward()
        for k, v in part.items():
            total[k] += float(v.detach())
    total["total_loss"] = sum(
        wts[k] * total[k] for k in wts
        if k in LOC_LOSSES or counts[next(t for t, n, _ in TEXT_LOSSES
                                          if n == k)] > 0)
    return total


def train(P, W, kinds, model, losses_cfg, training, batches,
          first_update: int, total_updates: int, device, block: int = 20):
    """Run the steps over `batches` from the weights W (fp32, changed in
    place; `kinds` as `gpv.param_spec` gives them). Returns per step its
    losses, and the first step's gradient as AdamW took it (after the
    clip)."""
    leaves = {n: t for n, t in W.items() if trainable(n, kinds[n])}
    for t in leaves.values():
        t.requires_grad_(True)
    m = {n: torch.zeros_like(t) for n, t in leaves.items()}
    v = {n: torch.zeros_like(t) for n, t in leaves.items()}
    lr, lr_bb = float(training["lr"]), float(training["lr_backbone"])
    wd = float(training["weight_decay"])
    out = {"losses": []}
    for k, batch in enumerate(batches):
        for t in leaves.values():
            t.grad = None
        out["losses"].append(step_losses(P, W, model, losses_cfg, batch,
                                         device, block))
        grads = {n: (t.grad if t.grad is not None else torch.zeros_like(t))
                 for n, t in leaves.items()}
        clip = [g for n, g in grads.items() if clipped(n)]
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in clip]))
        coef = torch.clamp(float(training["clip_max_norm"]) / (norm + 1e-6),
                           max=1.0)
        for n in grads:
            if clipped(n):
                grads[n] = grads[n] * coef
        if k == 0:
            out["grad"] = {n: g.detach().clone() for n, g in grads.items()}
        mult = lr_multiplier(first_update + k, total_updates,
                             float(training["lr_warmup_fraction"]))
        t_ = k + 1
        with torch.no_grad():
            for n, p in leaves.items():
                step_lr = (lr_bb if n.startswith("detr.backbone.") else lr) \
                    * mult
                g = grads[n]
                p.mul_(1 - step_lr * wd)
                m[n].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                v[n].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                denom = (v[n].sqrt() / math.sqrt(1 - BETAS[1] ** t_)) + EPS
                p.addcdiv_(m[n], denom, value=-step_lr / (1 - BETAS[0] ** t_))
    for t in leaves.values():
        t.requires_grad_(False)
        t.grad = None
    out["leaves"] = list(leaves)
    return out
