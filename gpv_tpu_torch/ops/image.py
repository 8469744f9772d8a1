"""Image preprocessing (counterpart of `gpv_tpu/ops/image.py`): the
torchvision `ToTensor` + ImageNet `Normalize` the reference applies, on
(..., 3) channel-last images in [0, 1], and the on-device linear,
anti-aliased resize the JAX package folds into its graph."""
from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
_EPS32 = float(torch.finfo(torch.float32).eps)


def _resize_weights(n_in: int, n_out: int, antialias: bool,
                    device) -> torch.Tensor:
    """(n_in, n_out) fp32 weights of one axis, as
    `jax.image.scale_and_translate` builds them for the linear (triangle)
    kernel at scale n_out / n_in and no translation: the kernel is widened
    by 1 / scale when downsampling with `antialias`, each output's weights
    are normalised to sum to 1, and an output sampled outside the input
    gets none."""
    inv = 1.0 / (n_out / n_in)
    kernel_scale = max(inv, 1.0) if antialias else 1.0
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) \
        * inv - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32,
                                        device=device)[:, None]).abs() \
        / kernel_scale
    w = (1.0 - x).clamp_min(0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _EPS32,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize_image(img: torch.Tensor, height: int = 480, width: int = 640,
                 antialias: bool = True) -> torch.Tensor:
    """Resize (..., H, W, C) image(s) to (..., height, width, C), linear,
    anti-aliased on downscale: `jax.image.resize(method="linear",
    antialias=True)`'s arithmetic, one weight matrix an axis contracted
    with the image (an axis whose size does not change is left as it
    is). fp32 out."""
    x = img.float()
    h, w = x.shape[-3], x.shape[-2]
    if h != height:
        x = torch.einsum("...hwc,hy->...ywc", x,
                         _resize_weights(h, height, antialias, x.device))
    if w != width:
        x = torch.einsum("...ywc,wx->...yxc", x,
                         _resize_weights(w, width, antialias, x.device))
    return x


def normalize_image(img: torch.Tensor) -> torch.Tensor:
    """Normalise (..., 3) float images in [0, 1] with ImageNet stats."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=img.dtype, device=img.device)
    std = torch.tensor(IMAGENET_STD, dtype=img.dtype, device=img.device)
    return (img - mean) / std


def preprocess(img_uint8: torch.Tensor, height: int = 480, width: int = 640,
               resize: bool = True) -> torch.Tensor:
    """uint8 (..., H, W, 3) -> normalised fp32, optionally resized."""
    x = img_uint8.float() / 255.0
    if resize:
        x = resize_image(x, height, width)
    return normalize_image(x)
