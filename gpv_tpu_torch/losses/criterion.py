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
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from ..ops.boxes import box_cxcywh_to_xyxy, elementwise_generalized_box_iou
from ..ops.matcher import hungarian_match

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


def text_ce_losses(answer_logits: torch.Tensor, answer_ids: torch.Tensor,
                   answer_lens: torch.Tensor, task_id: torch.Tensor,
                   has_answer: torch.Tensor) -> Dict[str, tuple]:
    """Per-task teacher-forced CE: {task: (loss, sample count)}.

    answer_logits (B,S-1,V) for positions 1..S-1; answer_ids (B,S) with
    the leading __cls__; answer_lens (B,) encoded lengths (cls..stop);
    task_id (B,) ints, has_answer (B,) bool."""
    logits = answer_logits.float()
    tgt = answer_ids[:, 1:].long()
    # CE as logsumexp minus the target logit: the (B,S-1,V) log-softmax is
    # never materialised for the gather
    ce = torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, tgt[..., None])[..., 0]                      # (B,S-1)
    # the reference pads to the batch's longest answer: positions below
    # max(len) - 1 count
    smax = torch.where(has_answer, answer_lens, 0).max()
    pos_ok = torch.arange(tgt.shape[1], device=tgt.device)[None] < smax - 1
    per_sample = (ce * pos_ok).sum(1)
    out = {}
    for task in TEXT_TASKS:
        mask = (task_id == TASK_IDS[task]) & has_answer
        cnt = mask.sum().float()
        out[task] = (_safe_div((per_sample * mask).sum(), cnt), cnt)
    return out


def localization_losses(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                        tgt_boxes: torch.Tensor, tgt_labels: torch.Tensor,
                        box_valid: torch.Tensor, has_boxes: torch.Tensor,
                        cfg: LossConfig,
                        q4t: torch.Tensor | None = None) -> Dict[str, tuple]:
    """DETR set losses over Hungarian-matched pairs: {name: (loss, count)}.

    pred_logits (B,Q,K+1), pred_boxes (B,Q,4) cxcywh; tgt_boxes (B,M,4),
    tgt_labels (B,M), box_valid (B,M) bool; has_boxes (B,) bool (the sample
    carries box supervision). `q4t` (B,M), the matching, is computed here
    unless given."""
    B, Q, K1 = pred_logits.shape
    valid = box_valid & has_boxes[:, None]                        # (B,M)
    if q4t is None:
        q4t = hungarian_match(pred_logits.detach(), pred_boxes.detach(),
                              tgt_labels, tgt_boxes, valid, cfg.cost_class,
                              cfg.cost_bbox, cfg.cost_giou)
    num_boxes = valid.sum().float().clamp(min=1.0)
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
    loss_ce = _safe_div((w * ce).sum(), w.sum())

    # box losses over the matched pairs
    src = torch.gather(boxes, 1, q4t[..., None].expand(B, q4t.shape[1], 4))
    tgt = tgt_boxes.float()
    loss_bbox = ((src - tgt).abs().sum(-1) * valid).sum() / num_boxes
    giou = elementwise_generalized_box_iou(box_cxcywh_to_xyxy(src),
                                           box_cxcywh_to_xyxy(tgt))
    loss_giou = ((1.0 - giou) * valid).sum() / num_boxes

    cnt = has_boxes.sum().float()
    card = ((pred_logits.argmax(-1) != K1 - 1).sum(-1)
            - valid.sum(-1)).abs() * has_boxes
    return {"loss_ce": (loss_ce, cnt), "loss_bbox": (loss_bbox, cnt),
            "loss_giou": (loss_giou, cnt),
            "cardinality_error": (_safe_div(card.sum().float(), cnt), cnt)}


_LOC_TERMS = ("loss_ce", "loss_bbox", "loss_giou")


def gpv_criterion(outputs: dict, batch: dict, cfg: LossConfig):
    """Total multitask loss (0-d tensor) and the loss dict.

    `batch`: answer_ids (B,S), answer_lens (B,), task_id (B,),
    has_answer (B,), boxes (B,M,4), box_labels (B,M), box_valid (B,M),
    has_boxes (B,)."""
    losses: Dict[str, torch.Tensor] = {}
    total = torch.zeros((), device=outputs["pred_boxes"].device)

    def add(name, val, cnt, wt):
        nonlocal total
        losses[name] = val
        total = total + wt * torch.where(cnt > 0, val, 0.0)

    if "answer_logits" in outputs:
        text = text_ce_losses(outputs["answer_logits"], batch["answer_ids"],
                              batch["answer_lens"], batch["task_id"],
                              batch["has_answer"])
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
        batch["has_boxes"], cfg)
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
                batch["box_valid"], batch["has_boxes"], cfg)
            for name in _LOC_TERMS:
                add(f"{name}_{i}", *loc_i[name], weights[name])

    losses["total_loss"] = total
    return total, losses
