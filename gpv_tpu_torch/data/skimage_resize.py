"""skimage-0.17.2-exact host resize (the reference's eval pixel path); the
port's copy of `gpv_tpu/data/skimage_resize.py`, scipy imported at use.

Behavior spec: every pixel of released-checkpoint eval flows through
`skimage.transform.resize(img, (imh, imw), anti_aliasing=True)`
(reference `datasets/coco_generic_dataset.py:61`,
`inference_util.py:22`; scikit-image pinned to 0.17.2 in
`setup_conda_env.sh:5`). scikit-image is not a dependency, so this module
reconstructs that exact algorithm from scipy.ndimage + numpy:

skimage 0.17.2 `resize(image, output_shape, anti_aliasing=True)` with the
reference's defaults (order=1, mode='reflect', cval=0, clip=True,
preserve_range=False) is, step for step:

1. factors = input_shape / output_shape per axis (channel axis factor 1).
2. anti-aliasing prefilter: sigma = max(0, (factors - 1) / 2) per axis,
   `ndi.gaussian_filter(image, sigma, cval=0, mode='mirror')` — skimage
   translates its numpy-pad-style 'reflect' to ndi 'mirror'
   (d c b | a b c d | c b a, no edge repeat). CRITICALLY, 0.17.2 filters
   the image at its INPUT dtype (float conversion happens later, inside
   warp): a uint8 COCO jpeg is smoothed in uint8, quantizing after each
   separable 1-D pass. 0.19+ converts to float first; the reference pins
   0.17.2, so the uint8-stage quirk is reproduced here (and delegated to
   the installed scipy, exactly as skimage delegates to its scipy).
3. float conversion (warp's `convert_to_float`, preserve_range=False):
   uint8 -> float64 / 255.
4. order-1 warp with the center-aligned inverse map
   src = factor * (dst + 0.5) - 0.5 per axis (skimage builds this as an
   AffineTransform from corner points; axis-aligned, so it separates into
   two 1-D linear interpolations), out-of-range neighbors mirrored.
5. clip=True clips to the input's [min, max] — a no-op for order-1's
   convex weights, applied anyway for fidelity.
"""
from __future__ import annotations

import numpy as np


def _mirror_index(idx: np.ndarray, n: int) -> np.ndarray:
    """numpy-pad-'reflect' (ndi 'mirror') index mapping: no edge repeat."""
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * (n - 1)
    idx = np.abs(idx) % period
    return np.where(idx >= n, period - idx, idx)


def _axis_lerp(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """1-D linear interpolation along `axis` at the skimage grid positions
    src = factor * (dst + 0.5) - 0.5, mirror boundary."""
    n = img.shape[axis]
    factor = n / out_size
    src = factor * (np.arange(out_size, dtype=np.float64) + 0.5) - 0.5
    lo = np.floor(src).astype(np.int64)
    frac = src - lo
    i0 = _mirror_index(lo, n)
    i1 = _mirror_index(lo + 1, n)
    a = np.take(img, i0, axis=axis)
    b = np.take(img, i1, axis=axis)
    shape = [1] * img.ndim
    shape[axis] = out_size
    w = frac.reshape(shape)
    # lerp form: one broadcast multiply instead of two (~2x faster on the
    # fp64 path); equals a*(1-w)+b*w within ~1 ulp (cross-validated against
    # ndi.zoom at <1e-12 in tests/test_skimage_resize.py)
    return a + (b - a) * w


def skimage_resize_exact(img: np.ndarray, output_shape: tuple[int, int],
                         anti_aliasing: bool = True) -> np.ndarray:
    """skimage-0.17.2 `transform.resize` for (H, W) or (H, W, C) input at
    the reference call pattern; returns float64 (uint8 scaled to [0, 1])."""
    if img.ndim not in (2, 3):
        raise ValueError(f"expected (H, W[, C]) image, got {img.shape}")
    h, w = int(output_shape[0]), int(output_shape[1])
    factors = [img.shape[0] / h, img.shape[1] / w] + [1.0] * (img.ndim - 2)

    if anti_aliasing:
        from scipy import ndimage as ndi
        sigma = [max(0.0, (f - 1.0) / 2.0) for f in factors]
        if any(s > 0 for s in sigma):
            # input-dtype filter — the 0.17.2 uint8 quantization quirk
            img = ndi.gaussian_filter(img, sigma, cval=0, mode="mirror")

    # warp's convert_to_float(preserve_range=False): img_as_float semantics
    if img.dtype == np.uint8:
        x = img.astype(np.float64) / 255.0
    elif img.dtype == np.uint16:
        x = img.astype(np.float64) / 65535.0
    else:
        x = img.astype(np.float64)

    in_min, in_max = float(x.min()), float(x.max())
    x = _axis_lerp(x, 0, h)
    x = _axis_lerp(x, 1, w)
    return np.clip(x, in_min, in_max)



def skimage_read_semantics(img: np.ndarray, imh: int, imw: int) -> np.ndarray:
    """The full reference `read_image` pixel path after imread
    (coco_generic_dataset.py:54-61): grayscale -> 3 channels, alpha
    dropped, then the exact anti-aliased resize. Returns float64 in
    [0, 1]."""
    if img.ndim == 2:
        img = np.tile(img[:, :, None], (1, 1, 3))
    else:
        img = img[:, :, :3]
    return skimage_resize_exact(img, (imh, imw), anti_aliasing=True)
