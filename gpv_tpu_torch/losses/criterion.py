"""GPV multitask criterion, static-shape and masked per task (counterpart of
`gpv_tpu/losses/criterion.py`).

Reference `exp/gpv/models/losses.py` (GPVCriterion: caption / VQA /
classification text CE plus Localization) and `utils/set_criterion.py`
(labels CE with the no-object class down-weighted, L1 and GIoU over the
Hungarian-matched pairs). The reference filters the batch per task; here,
as in the JAX package, every loss runs over the whole batch and is masked
per task, so a step's shapes and graph never depend on the task mix and no
boolean indexing is needed. Losses are computed in fp32.

Parity notes (as in the JAX package):
- text CE of a task = mean over its samples of the summed CE over the
  positions below the batch's longest answer (pads included, pad_idx null);
- localization normalises by the batch's valid target boxes, at least 1;
- labels CE uses torch's weighted-CE normalisation sum(w[y]·ce)/sum(w[y])
  with w = [1, eos_coef].

Over several processes (`group`, a `torch.distributed` process group) the
criterion computes each rank's part of the loss of the GLOBAL batch, as the
JAX step computes one loss over its sharded batch: every normaliser (the
answer-length bound, each task's sample count, the valid boxes, the
weighted-CE denominator, the box-supervised samples) is all-reduced over
the group, and each loss is scaled by the world size W, so that the mean
over ranks (DDP's gradient average, the logged losses) is the global
loss. DETR's reference normalises `num_boxes` the same way. With one
process (`group` None) nothing is reduced or scaled. Under tensor
parallelism `group` is the data group, and `replicas`, the model group,
whose ranks compute the same outputs, must reach the same Hungarian
assignment: it is checked, not broadcast.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops.boxes import box_cxcywh_to_xyxy, elementwise_generalized_box_iou
from ..ops.matcher import hungarian_match
from ..parallel.tensor_parallel import check_replicated

# task-id encoding shared by the datasets, the batches and the losses
TASK_IDS = {
    "CocoCaptioning": 0,
    "CocoVqa": 1,
    "CocoClassification": 2,
    "CocoDetection": 3,
    "RefCocop": 4,
}
TEXT_TASKS = ("CocoCaptioning", "CocoVqa", "CocoClassification")


class LossConfig(NamedTuple):
    caption_wt: float = 5e-2
    vqa_wt: float = 1.0
    cls_wt: float = 1.0
    loss_ce_wt: float = 1.0
    loss_bbox_wt: float = 5.0
    loss_giou_wt: float = 2.0
    cost_class: float = 1.0
    cost_bbox: float = 5.0
    cost_giou: float = 2.0
    eos_coef: float = 0.1
    num_classes: int = 1

    @classmethod
    def from_config(cls, cfg) -> "LossConfig":
        """Build from the `losses` node of configs/exp/gpv.yaml."""
        return cls(
            caption_wt=float(cfg.CaptionLoss.loss_wts.loss_caption),
            vqa_wt=float(cfg.VqaLoss.loss_wts.loss_vqa),
            cls_wt=float(cfg.ClsLoss.loss_wts.loss_cls),
            loss_ce_wt=float(cfg.Localization.loss_wts.loss_ce),
            loss_bbox_wt=float(cfg.Localization.loss_wts.loss_bbox),
            loss_giou_wt=float(cfg.Localization.loss_wts.loss_giou),
            cost_class=float(cfg.Localization.cost_wts.ce),
            cost_bbox=float(cfg.Localization.cost_wts.bbox),
            cost_giou=float(cfg.Localization.cost_wts.giou),
            eos_coef=float(cfg.Localization.eos_coef),
            num_classes=int(cfg.Localization.num_classes))


def _safe_div(num, den):
    return num / torch.clamp(den, min=1.0)


def _over(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """`x` reduced over `group` (a new tensor), or `x` without a group."""
    if group is None:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, op=op, group=group)
    return x


def optax_sigmoid_ce(logits: torch.Tensor,
                     labels: torch.Tensor) -> torch.Tensor:
    """Elementwise sigmoid cross-entropy, written as optax writes it
    (max(x, 0) - x y + log1p(exp(-|x|)))."""
    return (logits.clamp_min(0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       num_boxes, alpha: float = 0.25,
                       gamma: float = 2.0) -> torch.Tensor:
    """Segmentation focal loss (reference `utils/set_criterion.py` masks
    branch; unused in the default GPV config where masks=False, kept for
    capability parity as the JAX package keeps it). logits/targets:
    (N, P)."""
    prob = torch.sigmoid(logits)
    ce = optax_sigmoid_ce(logits, targets)
    p_t = prob * targets + (1 - prob) * (1 - targets)
    loss = ce * ((1 - p_t) ** gamma)
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    loss = loss.mean(1).sum()
    return _safe_div(loss, torch.as_tensor(num_boxes, dtype=loss.dtype,
                                           device=loss.device))


def dice_loss(logits: torch.Tensor, targets: torch.Tensor,
              num_boxes) -> torch.Tensor:
    """Mask dice loss (same provenance as `sigmoid_focal_loss`)."""
    probs = torch.sigmoid(logits)
    numerator = 2 * (probs * targets).sum(1)
    denominator = probs.sum(1) + targets.sum(1)
    loss = (1 - (numerator + 1) / (denominator + 1)).sum()
    return _safe_div(loss, torch.as_tensor(num_boxes, dtype=loss.dtype,
                                           device=loss.device))


def text_ce_losses(answer_logits: torch.Tensor, answer_ids: torch.Tensor,
                   answer_lens: torch.Tensor, task_id: torch.Tensor,
                   has_answer: torch.Tensor,
                   group=None) -> Dict[str, tuple]:
    """Per-task teacher-forced CE: {task: (loss, sample count)}.

    answer_logits (B,S-1,V) for positions 1..S-1; answer_ids (B,S) with
    the leading __cls__; answer_lens (B,) encoded lengths (cls..stop);
    task_id (B,) ints, has_answer (B,) bool. With `group`, the bound and
    the counts are the group's (module docstring)."""
    logits = answer_logits.float()
    tgt = answer_ids[:, 1:].long()
    # CE as logsumexp minus the target logit: the (B,S-1,V) log-softmax is
    # never materialised for the gather
    ce = torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, tgt[..., None])[..., 0]                      # (B,S-1)
    # the reference pads to the batch's longest answer: positions below
    # max(len) - 1 count
    smax = _over(torch.where(has_answer, answer_lens, 0).max(), group,
                 dist.ReduceOp.MAX)
    pos_ok = torch.arange(tgt.shape[1], device=tgt.device)[None] < smax - 1
    per_sample = (ce * pos_ok).sum(1)
    out = {}
    for task in TEXT_TASKS:
        mask = (task_id == TASK_IDS[task]) & has_answer
        cnt = _over(mask.sum().float(), group)
        out[task] = (_safe_div((per_sample * mask).sum(), cnt), cnt)
    return out


def localization_losses(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                        tgt_boxes: torch.Tensor, tgt_labels: torch.Tensor,
                        box_valid: torch.Tensor, has_boxes: torch.Tensor,
                        cfg: LossConfig,
                        q4t: torch.Tensor | None = None,
                        group=None, replicas=None) -> Dict[str, tuple]:
    """DETR set losses over Hungarian-matched pairs: {name: (loss, count)}.

    pred_logits (B,Q,K+1), pred_boxes (B,Q,4) cxcywh; tgt_boxes (B,M,4),
    tgt_labels (B,M), box_valid (B,M) bool; has_boxes (B,) bool (the sample
    carries box supervision). `q4t` (B,M), the matching, is computed here
    unless given (and checked equal over `replicas`). With `group`, the
    normalisers are the group's (module docstring)."""
    B, Q, K1 = pred_logits.shape
    valid = box_valid & has_boxes[:, None]                        # (B,M)
    if q4t is None:
        q4t = hungarian_match(pred_logits.detach(), pred_boxes.detach(),
                              tgt_labels, tgt_boxes, valid, cfg.cost_class,
                              cfg.cost_bbox, cfg.cost_giou)
        check_replicated(torch.where(valid, q4t, -1), replicas,
                         "the Hungarian assignment")
    num_boxes = _over(valid.sum().float(), group).clamp(min=1.0)
    logits, boxes = pred_logits.float(), pred_boxes.float()

    # labels CE: matched queries take their target's label, the rest the
    # no-object class K
    assign = F.one_hot(q4t, Q).float() * valid[..., None]         # (B,M,Q)
    matched = assign.sum(1)                                       # (B,Q)
    lbl = torch.einsum("bm,bmq->bq", tgt_labels.float() + 1, assign)
    target_classes = torch.where(matched > 0, lbl - matched,
                                 float(cfg.num_classes)).long()
    ce = -torch.gather(logits.log_softmax(-1), -1,
                       target_classes[..., None])[..., 0]
    w = torch.where(target_classes == cfg.num_classes, cfg.eos_coef, 1.0)
    w = w * has_boxes[:, None]
    loss_ce = _safe_div((w * ce).sum(), _over(w.sum(), group))

    # box losses over the matched pairs
    src = torch.gather(boxes, 1, q4t[..., None].expand(B, q4t.shape[1], 4))
    tgt = tgt_boxes.float()
    loss_bbox = ((src - tgt).abs().sum(-1) * valid).sum() / num_boxes
    giou = elementwise_generalized_box_iou(box_cxcywh_to_xyxy(src),
                                           box_cxcywh_to_xyxy(tgt))
    loss_giou = ((1.0 - giou) * valid).sum() / num_boxes

    cnt = _over(has_boxes.sum().float(), group)
    card = ((pred_logits.argmax(-1) != K1 - 1).sum(-1)
            - valid.sum(-1)).abs() * has_boxes
    return {"loss_ce": (loss_ce, cnt), "loss_bbox": (loss_bbox, cnt),
            "loss_giou": (loss_giou, cnt),
            "cardinality_error": (_safe_div(card.sum().float(), cnt), cnt)}


_LOC_TERMS = ("loss_ce", "loss_bbox", "loss_giou")


def gpv_criterion(outputs: dict, batch: dict, cfg: LossConfig, group=None,
                  replicas=None):
    """Total multitask loss (0-d tensor) and the loss dict.

    `batch`: answer_ids (B,S), answer_lens (B,), task_id (B,),
    has_answer (B,), boxes (B,M,4), box_labels (B,M), box_valid (B,M),
    has_boxes (B,). With `group`, this rank's part of the global batch's
    loss times the world size; `replicas` as in `localization_losses`
    (module docstring)."""
    losses: Dict[str, torch.Tensor] = {}
    total = torch.zeros((), device=outputs["pred_boxes"].device)

    def add(name, val, cnt, wt):
        nonlocal total
        losses[name] = val
        total = total + wt * torch.where(cnt > 0, val, 0.0)

    if "answer_logits" in outputs:
        text = text_ce_losses(outputs["answer_logits"], batch["answer_ids"],
                              batch["answer_lens"], batch["task_id"],
                              batch["has_answer"], group)
        for task, wt, name in (
                ("CocoCaptioning", cfg.caption_wt, "loss_caption"),
                ("CocoVqa", cfg.vqa_wt, "loss_vqa"),
                ("CocoClassification", cfg.cls_wt, "loss_cls")):
            add(name, *text[task], wt)

    weights = dict(zip(_LOC_TERMS, (cfg.loss_ce_wt, cfg.loss_bbox_wt,
                                    cfg.loss_giou_wt)))
    loc = localization_losses(
        outputs["pred_relevance_logits"], outputs["pred_boxes"],
        batch["boxes"], batch["box_labels"], batch["box_valid"],
        batch["has_boxes"], cfg, group=group, replicas=replicas)
    for name in _LOC_TERMS:
        add(name, *loc[name], weights[name])
    losses["cardinality_error"] = loc["cardinality_error"][0]

    # aux decoder layers: each matched on its own
    if "aux_pred_relevance_logits" in outputs:
        aux_l = outputs["aux_pred_relevance_logits"]
        aux_b = outputs["aux_pred_boxes"]
        for i in range(aux_l.shape[0]):
            loc_i = localization_losses(
                aux_l[i], aux_b[i], batch["boxes"], batch["box_labels"],
                batch["box_valid"], batch["has_boxes"], cfg, group=group,
                replicas=replicas)
            for name in _LOC_TERMS:
                add(f"{name}_{i}", *loc_i[name], weights[name])

    losses["total_loss"] = total
    if group is not None:
        world = dist.get_world_size(group)
        losses = {k: v * world for k, v in losses.items()}
        total = losses["total_loss"]
    return total, losses
