"""COCO task datasets (host side): sample JSONs -> augmented fixed-size
images + queries + targets (counterpart of `gpv_tpu/datasets/coco.py`).

Behavior spec: reference `datasets/coco_generic_dataset.py` and
`datasets/coco_datasets.py` —
  GenericCocoDataset: loads per-subset sample JSON; reads image (grayscale ->
  3ch), resizes to the fixed task image_size (480x640); targets carry
  normalized cxcywh boxes when the sample has boxes, the answer string when
  it has one, and the task name.
  CocoVqa: resamples the answer from `all_answers` entries with freq > 2
  (training only).
  CocoClassification: crops the object box with a 0.2*w/h margin (min 5 px)
  before resizing; no box targets.
  Test-server variants: VQA test/testdev, captioning val/test with per-image
  dedup.

A sample's pixels come from one method, `load_pixels(sample)`: by default
the COCO JPEG under `image_dir` (PIL, imported where it is read). A
subclass may supply pixels another way; crop, resize, box normalisation
and transforms stay this module's. Images come back as fixed-size uint8
HWC; float conversion and ImageNet normalisation happen on the device
(`gpv_tpu_torch.ops.image`).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List

import numpy as np

from .image import load_image, resize_uint8
from .transforms import Compose, eval_transforms, train_transforms


def coco_image_path(image_dir: str, subset: str, image_id: int) -> Path:
    return (Path(image_dir) / subset
            / f"COCO_{subset}_{int(image_id):012d}.jpg")


class GenericCocoDataset:
    """One task's sample list. `task` tags targets like the reference
    subclasses do."""

    task: str = "Generic"
    has_box_targets: bool = True

    def __init__(self, cfg, subset: str, training: bool = False):
        self.cfg = cfg
        self.subset = subset
        self.training = training
        self.imh = int(cfg.image_size.H)
        self.imw = int(cfg.image_size.W)
        self.read_image = bool(cfg.get("read_image", True))
        # host_resize: pil (default) | native | exact (datasets/image.py)
        self.resize_method = str(cfg.get("host_resize", "pil"))
        samples = json.loads(Path(cfg.samples[subset]).read_text())
        max_samples = (cfg.get("max_samples") or {}).get(subset)
        if max_samples is not None:
            samples = samples[:int(max_samples)]
        self.samples: List[Dict[str, Any]] = samples
        self.transforms: Compose = (train_transforms(self.task) if training
                                    else eval_transforms())
        if training or self.resize_method == "native":
            # the fused jitter and the native resize: built and loaded here,
            # in the process that forks the loader's workers
            from ..native import load_native
            load_native()

    def __len__(self):
        return len(self.samples)

    def load_pixels(self, sample) -> np.ndarray:
        """The sample's whole image, (H, W, 3) uint8."""
        return load_image(coco_image_path(self.cfg.image_dir,
                                          sample["image"]["subset"],
                                          sample["image"]["image_id"]))

    def _read(self, sample) -> tuple[np.ndarray, tuple[int, int]]:
        img = self.load_pixels(sample)
        original_size = img.shape[:2]
        img = resize_uint8(img, self.imh, self.imw,
                           method=self.resize_method)
        return img, original_size

    def get_boxes_cxcywh(self, coco_boxes) -> np.ndarray:
        boxes = np.asarray(coco_boxes, np.float32).reshape(-1, 4)
        out = boxes.copy()
        out[:, 0] = boxes[:, 0] + 0.5 * boxes[:, 2]
        out[:, 1] = boxes[:, 1] + 0.5 * boxes[:, 3]
        return out

    def __getitem__(self, i: int):
        return self.get(i, np.random.RandomState())

    def get(self, i: int, rng: np.random.RandomState) -> Dict[str, Any]:
        sample = self.samples[i]
        out: Dict[str, Any] = {"query": sample["query"], "task": self.task,
                               "sample": sample}
        if self.read_image:
            img, (H, W) = self._read(sample)
            out["image"] = self.transforms(img, rng).astype(np.uint8)
            out["original_size"] = (H, W)
            if self.has_box_targets and "boxes" in sample:
                b = self.get_boxes_cxcywh(sample["boxes"])
                b[:, 0] /= W
                b[:, 1] /= H
                b[:, 2] /= W
                b[:, 3] /= H
                out["boxes"] = b
        elif self.has_box_targets and "boxes" in sample:
            out["boxes"] = self.get_boxes_cxcywh(sample["boxes"])
        if "answer" in sample:
            out["answer"] = sample["answer"]
        return out


class CocoCaptioning(GenericCocoDataset):
    task = "CocoCaptioning"


class CocoDetection(GenericCocoDataset):
    task = "CocoDetection"


class RefCocop(GenericCocoDataset):
    task = "RefCocop"


class CocoVqa(GenericCocoDataset):
    task = "CocoVqa"
    has_box_targets = False

    def get(self, i, rng):
        out = super().get(i, rng)
        sample = self.samples[i]
        if self.training:
            pool = []
            for answer, freq in sample.get("all_answers", {}).items():
                if freq > 2:
                    pool.extend([answer] * freq)
            if pool:
                out["answer"] = pool[rng.randint(len(pool))]
        return out


class CocoClassification(GenericCocoDataset):
    task = "CocoClassification"
    has_box_targets = False

    def _read(self, sample):
        img = self.load_pixels(sample)
        H, W = img.shape[:2]
        x, y, w, h = sample["boxes"]
        w, h = max(w, 5), max(h, 5)
        x1 = min(max(0, int(x - 0.2 * w)), W)
        x2 = min(max(0, int(x + 1.2 * w)), W)
        y1 = min(max(0, int(y - 0.2 * h)), H)
        y2 = min(max(0, int(y + 1.2 * h)), H)
        crop = img[y1:y2, x1:x2]
        original_size = crop.shape[:2]
        return (resize_uint8(crop, self.imh, self.imw,
                             method=self.resize_method), original_size)


class CocoVqaTestOriginalSplit(CocoVqa):
    """VQA test-server split: queries only, no targets."""

    def get(self, i, rng):
        out = super().get(i, rng)
        out.pop("answer", None)
        return out


class CocoCapTestOriginalSplit(CocoCaptioning):
    """Captioning test-server split; val is deduplicated per image."""

    def __init__(self, cfg, subset, training=False):
        super().__init__(cfg, subset, training)
        if subset == "val":
            dedup = {}
            for s in self.samples:
                dedup[s["image"]["image_id"]] = s
            self.samples = list(dedup.values())

    def get(self, i, rng):
        out = super().get(i, rng)
        out.pop("answer", None)
        out.pop("boxes", None)
        return out


DATASET_CLASSES = {
    "CocoCaptioning": CocoCaptioning,
    "CocoDetection": CocoDetection,
    "CocoClassification": CocoClassification,
    "CocoVqa": CocoVqa,
    "RefCocop": RefCocop,
    "CocoVqaTestOriginalSplitDataset": CocoVqaTestOriginalSplit,
    "CocoCapTestOriginalSplitDataset": CocoCapTestOriginalSplit,
}


class CocoMultitaskDataset:
    """Concatenation over task datasets with cumulative index ranges
    (reference `datasets/coco_multitask_dataset.py:9-49`)."""

    def __init__(self, learning_datasets_cfg, task_configs, subset: str,
                 training: bool = False):
        self.datasets: List[GenericCocoDataset] = []
        self.names: List[str] = []
        for cls_name, ds_cfg in learning_datasets_cfg.items():
            task_cfg = task_configs[ds_cfg.task_config]
            ds = DATASET_CLASSES[cls_name](task_cfg, subset, training)
            self.datasets.append(ds)
            self.names.append(cls_name)
        self.offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self.offsets[-1])

    def get(self, i: int, rng: np.random.RandomState):
        k = int(np.searchsorted(self.offsets, i, side="right") - 1)
        return self.datasets[k].get(i - int(self.offsets[k]), rng)

    def __getitem__(self, i):
        return self.get(i, np.random.RandomState())
