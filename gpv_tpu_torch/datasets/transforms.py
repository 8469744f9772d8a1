"""Host-side image augmentations, C++ and numpy (counterpart of
`gpv_tpu/datasets/transforms.py`).

Behavior spec: reference train transforms —
  generic: ColorJitter(0.2,0.2,0.2,[no hue]) applied with p=0.8
    (`datasets/coco_generic_dataset.py:26-39`),
  det/cls/refexp: ColorJitter(0.4,0.4,0.4,0.1) p=0.8 + RandomGrayscale(0.2)
    (+ RandomHorizontalFlip for classification)
    (`datasets/coco_datasets.py:26-43,137-155,199-216`).
Implemented with torchvision's sampling semantics: factors drawn uniformly
from [max(0,1-x), 1+x], hue from [-h, h], applied in a random order, all
from the caller's `RandomState`. `ColorJitter` and `RandomGrayscale` apply
the drawn ops in one pass of the native runtime's fused C++ jitter
(`gpv_tpu_torch.native.color_jitter_native`) by default, or with
`native=False` in numpy, the fused jitter's reference. Both draw the same
random stream in the same order. A jitter that cannot be built raises;
unlike the JAX package, nothing falls back to numpy silently.
"""
from __future__ import annotations

import numpy as np

from .. import native as _native


def _blend(img: np.ndarray, other: np.ndarray, factor: float) -> np.ndarray:
    out = factor * img + (1.0 - factor) * other
    return np.clip(out, 0.0, 255.0)


def _grayscale(img: np.ndarray) -> np.ndarray:
    # itu-r 601-2 luma (PIL convert('L'))
    g = img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114
    return g[..., None]


def adjust_brightness(img, factor):
    return _blend(img, np.zeros_like(img), factor)


def adjust_contrast(img, factor):
    mean = _grayscale(img).mean()
    return _blend(img, np.full_like(img, mean), factor)


def adjust_saturation(img, factor):
    return _blend(img, np.broadcast_to(_grayscale(img), img.shape), factor)


def adjust_hue(img, factor):
    """factor in [-0.5, 0.5]: shift hue channel in HSV space."""
    x = img / 255.0
    maxc = x.max(-1)
    minc = x.min(-1)
    v = maxc
    deltac = maxc - minc
    s = np.where(maxc > 0, deltac / np.maximum(maxc, 1e-12), 0.0)
    dc = np.maximum(deltac, 1e-12)
    rc = (maxc - x[..., 0]) / dc
    gc = (maxc - x[..., 1]) / dc
    bc = (maxc - x[..., 2]) / dc
    h = np.where(x[..., 0] == maxc, bc - gc,
                 np.where(x[..., 1] == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = (h / 6.0) % 1.0
    h = np.where(deltac == 0, 0.0, h)
    h = (h + factor) % 1.0
    # hsv -> rgb
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = (i.astype(np.int32) % 6)[..., None]
    out = np.select(
        [i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
        [np.stack([v, t, p], -1), np.stack([q, v, p], -1),
         np.stack([p, v, t], -1), np.stack([p, q, v], -1),
         np.stack([t, p, v], -1), np.stack([v, p, q], -1)])
    return np.clip(out * 255.0, 0, 255)


class ColorJitter:
    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0,
                 hue=0.0, p=0.8):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue
        self.p = p

    def __call__(self, img: np.ndarray, rng: np.random.RandomState,
                 native: bool = True):
        if rng.rand() >= self.p:
            return img
        # a fresh copy: the fused jitter works in place
        img = np.array(img, dtype=np.float32, order="C")
        codes, factors, fns = [], [], []
        if self.brightness > 0:
            f = rng.uniform(max(0, 1 - self.brightness), 1 + self.brightness)
            codes.append(_native.JITTER_BRIGHTNESS)
            factors.append(f)
            fns.append(lambda x, f=f: adjust_brightness(x, f))
        if self.contrast > 0:
            f = rng.uniform(max(0, 1 - self.contrast), 1 + self.contrast)
            codes.append(_native.JITTER_CONTRAST)
            factors.append(f)
            fns.append(lambda x, f=f: adjust_contrast(x, f))
        if self.saturation > 0:
            f = rng.uniform(max(0, 1 - self.saturation), 1 + self.saturation)
            codes.append(_native.JITTER_SATURATION)
            factors.append(f)
            fns.append(lambda x, f=f: adjust_saturation(x, f))
        if self.hue > 0:
            f = rng.uniform(-self.hue, self.hue)
            codes.append(_native.JITTER_HUE)
            factors.append(f)
            fns.append(lambda x, f=f: adjust_hue(x, f))
        order = rng.permutation(len(codes))
        if native:
            return _native.color_jitter_native(
                img, [codes[i] for i in order], [factors[i] for i in order])
        for i in order:
            img = fns[i](img)
        return img


class RandomGrayscale:
    def __init__(self, p=0.2):
        self.p = p

    def __call__(self, img, rng, native: bool = True):
        if rng.rand() < self.p:
            if native and img.shape[-1] == 3:
                return _native.color_jitter_native(
                    np.array(img, dtype=np.float32, order="C"),
                    [_native.JITTER_GRAYSCALE], [0.0])
            g = _grayscale(img.astype(np.float32))
            return np.broadcast_to(g, img.shape).copy()
        return img


class RandomHorizontalFlip:
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, img, rng):
        if rng.rand() < self.p:
            return img[:, ::-1].copy()
        return img


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, img, rng):
        for t in self.transforms:
            img = t(img, rng)
        return img


def train_transforms(task: str) -> Compose:
    """Per-task train-time augmentation stacks (see module docstring)."""
    if task in ("CocoDetection", "RefCocop"):
        return Compose([ColorJitter(0.4, 0.4, 0.4, 0.1, p=0.8),
                        RandomGrayscale(0.2)])
    if task == "CocoClassification":
        return Compose([ColorJitter(0.4, 0.4, 0.4, 0.1, p=0.8),
                        RandomHorizontalFlip(0.5), RandomGrayscale(0.2)])
    return Compose([ColorJitter(0.2, 0.2, 0.2, 0.0, p=0.8)])


def eval_transforms() -> Compose:
    return Compose([])
