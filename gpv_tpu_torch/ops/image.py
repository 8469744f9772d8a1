"""Image normalisation (counterpart of `gpv_tpu/ops/image.py`): the
torchvision `ToTensor` + ImageNet `Normalize` the reference applies,
on (..., 3) channel-last images in [0, 1]."""
from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_image(img: torch.Tensor) -> torch.Tensor:
    """Normalise (..., 3) float images in [0, 1] with ImageNet stats."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=img.dtype, device=img.device)
    std = torch.tensor(IMAGENET_STD, dtype=img.dtype, device=img.device)
    return (img - mean) / std
