"""Host image loading and resizing (counterpart of
`gpv_tpu/datasets/coco.py:load_image` and `resize_uint8`).

PIL is imported where it is used: a serving host that only takes decoded
arrays does not need it.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

RESIZE_METHODS = ("pil", "native", "exact")


def load_image(path: str | Path) -> np.ndarray:
    """-> (H, W, 3) uint8; grayscale tiled to 3 channels, alpha dropped."""
    from PIL import Image
    img = np.asarray(Image.open(path))
    if img.ndim == 2:
        img = np.tile(img[:, :, None], (1, 1, 3))
    return img[:, :, :3]


def resize_uint8(img: np.ndarray, h: int, w: int,
                 method: str = "pil") -> np.ndarray:
    """Host resize to (h, w, 3) uint8. Methods:

    - "pil" (default): PIL bilinear, as the JAX package's default.
    - "exact": the skimage-0.17.2 anti-aliased path of the reference's eval
      pixels (`data/skimage_resize.py`), rounded to uint8.
    - "native": the C++ point-sampled bilinear resize of the native
      runtime (`gpv_tpu_torch.native`, built with g++ at first use), the
      training pipeline's. A failed build raises: unlike the JAX package,
      there is no silent fall-back to PIL (the card machine has no PIL).
    """
    if method not in RESIZE_METHODS:
        raise ValueError(f"unknown resize method {method!r}")
    if method == "native":
        from ..native import resize_bilinear_native
        return resize_bilinear_native(img.astype(np.uint8), h, w)
    if method == "exact":
        from ..data.skimage_resize import skimage_resize_exact
        out = skimage_resize_exact(img.astype(np.uint8), (h, w),
                                   anti_aliasing=True)
        return np.clip(np.rint(out * 255.0), 0, 255).astype(np.uint8)
    from PIL import Image
    return np.asarray(Image.fromarray(img.astype(np.uint8)).resize(
        (w, h), Image.BILINEAR))
