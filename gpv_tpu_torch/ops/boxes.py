"""Box geometry on tensors (counterpart of `gpv_tpu/ops/boxes.py`).

Reference `utils/box_ops.py`: cxcywh <-> xyxy, pairwise `box_iou` returning
(iou, union), `generalized_box_iou`, `masks_to_boxes`. As in the JAX package
nothing asserts: degenerate boxes give clamped intersections and areas, and
divisions are guarded by 1e-9.
"""
from __future__ import annotations

import torch


def box_cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    """(..., 4) [cx, cy, w, h] -> [x0, y0, x1, y1]."""
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w,
                        cy + 0.5 * h], dim=-1)


def box_xyxy_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    """(..., 4) [x0, y0, x1, y1] -> [cx, cy, w, h]."""
    x0, y0, x1, y1 = b.unbind(-1)
    return torch.stack([(x0 + x1) * 0.5, (y0 + y1) * 0.5, x1 - x0, y1 - y0],
                       dim=-1)


def box_area(b: torch.Tensor) -> torch.Tensor:
    """Area of (..., 4) xyxy boxes -> (...)."""
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """Pairwise IoU of xyxy boxes: (N,4), (M,4) -> iou (N,M), union (N,M)."""
    area1, area2 = box_area(boxes1), box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / union.clamp(min=1e-9), union


def generalized_box_iou(boxes1: torch.Tensor,
                        boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise GIoU of xyxy boxes -> (N, M)."""
    iou, union = box_iou(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.maximum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    area = wh[..., 0] * wh[..., 1]  # smallest enclosing box
    return iou - (area - union) / area.clamp(min=1e-9)


def elementwise_generalized_box_iou(boxes1: torch.Tensor,
                                    boxes2: torch.Tensor) -> torch.Tensor:
    """GIoU of aligned xyxy boxes: (..., 4), (..., 4) -> (...), the diagonal
    of `generalized_box_iou` without the N x N matrix."""
    area1, area2 = box_area(boxes1), box_area(boxes2)
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1 + area2 - inter
    iou = inter / union.clamp(min=1e-9)
    elt = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    erb = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    ewh = (erb - elt).clamp(min=0.0)
    earea = ewh[..., 0] * ewh[..., 1]
    return iou - (earea - union) / earea.clamp(min=1e-9)


def masks_to_boxes(masks: torch.Tensor) -> torch.Tensor:
    """(N, H, W) binary masks -> (N, 4) xyxy boxes (zeros for empty masks)."""
    n, h, w = masks.shape
    on = masks > 0
    ys = torch.arange(h, dtype=torch.float32, device=masks.device)[None, :,
                                                                   None]
    xs = torch.arange(w, dtype=torch.float32, device=masks.device)[None,
                                                                   None, :]
    big = 1e8
    x_min = torch.where(on, xs, big).amin(dim=(1, 2))
    x_max = torch.where(on, xs, -big).amax(dim=(1, 2))
    y_min = torch.where(on, ys, big).amin(dim=(1, 2))
    y_max = torch.where(on, ys, -big).amax(dim=(1, 2))
    boxes = torch.stack([x_min, y_min, x_max, y_max], dim=-1)
    return torch.where(on.any(dim=(1, 2))[:, None], boxes,
                       torch.zeros_like(boxes))
