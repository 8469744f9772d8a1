"""Boxes drawn on images for the training visualizations (counterpart of
`gpv_tpu/utils/visualize.py`; the reference draws with cv2 in
`exp/gpv/vis.py`). PIL is imported where it is used."""
from __future__ import annotations

from pathlib import Path

import numpy as np

PRED_COLOR = (255, 60, 60)
GT_COLOR = (60, 200, 60)


def add_box(draw, box_xyxy, color, label=None):
    x1, y1, x2, y2 = [float(v) for v in box_xyxy]
    draw.rectangle([x1, y1, x2, y2], outline=color, width=2)
    if label:
        draw.text((x1 + 2, max(0, y1 - 12)), str(label), fill=color)


def vis_sample(image_uint8: np.ndarray, pred_boxes_cxcywh, pred_scores,
               gt_boxes_cxcywh=None, num_boxes: int = 5, answer: str = ""):
    """A PIL image with the top `num_boxes` predicted boxes (red, with
    scores) and the GT boxes (green); boxes are normalised cxcywh."""
    from PIL import Image, ImageDraw
    img = Image.fromarray(image_uint8.astype(np.uint8)).convert("RGB")
    H, W = image_uint8.shape[:2]
    draw = ImageDraw.Draw(img)

    def to_xyxy(b):
        cx, cy, w, h = b
        return [(cx - w / 2) * W, (cy - h / 2) * H,
                (cx + w / 2) * W, (cy + h / 2) * H]

    if gt_boxes_cxcywh is not None:
        for b in np.asarray(gt_boxes_cxcywh).reshape(-1, 4):
            add_box(draw, to_xyxy(b), GT_COLOR)
    pred = np.asarray(pred_boxes_cxcywh).reshape(-1, 4)[:num_boxes]
    scores = np.asarray(pred_scores).reshape(-1)[:num_boxes]
    for b, s in zip(pred, scores):
        add_box(draw, to_xyxy(b), PRED_COLOR, f"{s:.2f}")
    if answer:
        draw.text((4, 4), answer, fill=(255, 255, 0))
    return img


def save_vis(img, path: str | Path):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    img.save(path)
