"""PASCAL-VOC average precision (host-side NumPy); the port's copy of
`gpv_tpu/evaluation/voc_ap.py`.

Behavior spec: `third_party/detection_metrics` (allenai/Object-Detection-
Metrics) `Evaluator.GetPascalVOCMetrics` as called per-sample by the
reference detection/refexp evaluators (`exp/gpv/evaluators.py:210-365`):
detections sorted by confidence, greedily matched to the free GT box with
highest IoU >= threshold (TP else FP), AP by every-point interpolation.
Boxes are xywh in relative coordinates.
"""
from __future__ import annotations

import numpy as np


def iou_xywh(a: np.ndarray, b: np.ndarray) -> float:
    ax1, ay1, ax2, ay2 = a[0], a[1], a[0] + a[2], a[1] + a[3]
    bx1, by1, bx2, by2 = b[0], b[1], b[0] + b[2], b[1] + b[3]
    ix1, iy1 = max(ax1, bx1), max(ay1, by1)
    ix2, iy2 = min(ax2, bx2), min(ay2, by2)
    iw, ih = max(0.0, ix2 - ix1), max(0.0, iy2 - iy1)
    inter = iw * ih
    union = a[2] * a[3] + b[2] * b[3] - inter
    if union <= 0:
        return 0.0
    return inter / union


def every_point_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """Every-point interpolated AP (area under the PR envelope)."""
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mpre[idx]))


def eleven_point_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    ap = 0.0
    for t in np.linspace(0, 1, 11):
        mask = recall >= t
        ap += (precision[mask].max() if mask.any() else 0.0) / 11.0
    return float(ap)


def voc_ap(pred_boxes_xywh: np.ndarray, pred_scores: np.ndarray,
           gt_boxes_xywh: np.ndarray, iou_thresh: float = 0.5,
           method: str = "every_point") -> float:
    """AP for one image/class group (the reference computes per-sample AP)."""
    npos = len(gt_boxes_xywh)
    order = np.argsort(-np.asarray(pred_scores), kind="stable")
    preds = np.asarray(pred_boxes_xywh, np.float64)[order]
    gts = np.asarray(gt_boxes_xywh, np.float64)
    matched = np.zeros(npos, bool)
    tp = np.zeros(len(preds))
    fp = np.zeros(len(preds))
    for d, box in enumerate(preds):
        best_iou, best_j = 0.0, -1
        for j, gt in enumerate(gts):
            i = iou_xywh(box, gt)
            if i > best_iou:
                best_iou, best_j = i, j
        if best_iou >= iou_thresh and not matched[best_j]:
            tp[d] = 1
            matched[best_j] = True
        else:
            fp[d] = 1
    acc_tp = np.cumsum(tp)
    acc_fp = np.cumsum(fp)
    recall = acc_tp / max(npos, 1)
    precision = acc_tp / np.maximum(acc_tp + acc_fp, 1e-12)
    if method == "every_point":
        return every_point_ap(recall, precision)
    return eleven_point_ap(recall, precision)
