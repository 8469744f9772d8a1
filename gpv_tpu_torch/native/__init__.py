"""The native host runtime: C++ functions for the host data path and the
matcher, loaded through ctypes (the port's copy of `gpv_tpu/native/`).

- `solve_lsap_native`: min-cost assignment of an (M, Q) or (B, M, Q) cost,
  M <= Q (`ops.matcher.solve_costs`).
- `resize_bilinear_native`: point-sampled bilinear uint8 resize
  (`host_resize: native`, `datasets.image.resize_uint8`).
- `color_jitter_native`: brightness, contrast, saturation, hue and
  grayscale in one in-place pass over a float32 image
  (`datasets.transforms.ColorJitter` / `RandomGrayscale`).

The library builds at first use (`build.build_native`). Each function counts
its calls (`.calls`, per process) so a run can show which path built its
data.
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from .build import build_native, load_native

_count_lock = threading.Lock()


def _count(fn) -> None:
    with _count_lock:
        fn.calls += 1


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def solve_lsap_native(cost: np.ndarray) -> np.ndarray:
    """(M, Q) or (B, M, Q) float cost, M <= Q -> the column assigned to
    each row, (M,) or (B, M) int32. A batch's images are solved on as many
    threads as this process may run on."""
    cost = np.ascontiguousarray(cost, np.float32)
    if cost.ndim not in (2, 3):
        raise ValueError(f"cost of shape {cost.shape}: (M, Q) or (B, M, Q)")
    *lead, m, q = cost.shape
    if m > q:
        raise ValueError(f"{m} rows for {q} columns: every row needs its "
                         "own column")
    lib = load_native()
    out = np.empty((*lead, m), np.int32)
    if cost.ndim == 2:
        rc = lib.solve_lsap(_ptr(cost, ctypes.c_float), m, q,
                            _ptr(out, ctypes.c_int32))
    else:
        rc = lib.solve_lsap_batch(_ptr(cost, ctypes.c_float), lead[0], m, q,
                                  _ptr(out, ctypes.c_int32),
                                  len(os.sched_getaffinity(0)))
    if rc != 0:
        raise RuntimeError(f"solve_lsap failed with code {rc} (-2: a cost "
                           "is not finite)")
    _count(solve_lsap_native)
    return out


def resize_bilinear_native(img_u8: np.ndarray, out_h: int,
                           out_w: int) -> np.ndarray:
    """(H, W, C) uint8 -> (out_h, out_w, C) uint8 bilinear resize."""
    img_u8 = np.ascontiguousarray(img_u8, np.uint8)
    if img_u8.ndim != 3 or min(img_u8.shape) < 1 or min(out_h, out_w) < 1:
        raise ValueError(f"resize of an image {img_u8.shape} to "
                         f"({out_h}, {out_w}): (H, W, C) and sizes >= 1")
    lib = load_native()
    h, w, c = img_u8.shape
    out = np.empty((out_h, out_w, c), np.uint8)
    lib.resize_bilinear_u8(_ptr(img_u8, ctypes.c_uint8), h, w, c,
                           _ptr(out, ctypes.c_uint8), out_h, out_w)
    _count(resize_bilinear_native)
    return out


# colour-jitter op codes shared with imageproc.cc
JITTER_BRIGHTNESS, JITTER_CONTRAST = 0, 1
JITTER_SATURATION, JITTER_HUE, JITTER_GRAYSCALE = 2, 3, 4


def color_jitter_native(img_f32: np.ndarray, ops, factors) -> np.ndarray:
    """Apply the jitter ops (codes above), each with its factor, in order,
    in place on a C-contiguous (H, W, 3) float32 image; returns it."""
    if (img_f32.dtype != np.float32 or not img_f32.flags.c_contiguous
            or img_f32.ndim != 3 or img_f32.shape[2] != 3):
        raise ValueError(f"jitter takes a C-contiguous (H, W, 3) float32 "
                         f"image, not {img_f32.dtype} {img_f32.shape}")
    ops_a = np.ascontiguousarray(ops, np.int32)
    fac_a = np.ascontiguousarray(factors, np.float32)
    if ops_a.shape != fac_a.shape or ops_a.ndim != 1:
        raise ValueError("one factor per jitter op")
    lib = load_native()
    h, w, _ = img_f32.shape
    lib.color_jitter_f32(_ptr(img_f32, ctypes.c_float), h, w,
                         _ptr(ops_a, ctypes.c_int32),
                         _ptr(fac_a, ctypes.c_float), len(ops_a))
    _count(color_jitter_native)
    return img_f32


for _fn in (solve_lsap_native, resize_bilinear_native, color_jitter_native):
    _fn.calls = 0

__all__ = ["build_native", "load_native", "solve_lsap_native",
           "resize_bilinear_native", "color_jitter_native",
           "JITTER_BRIGHTNESS", "JITTER_CONTRAST", "JITTER_SATURATION",
           "JITTER_HUE", "JITTER_GRAYSCALE"]
