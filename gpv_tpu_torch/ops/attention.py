"""Fused multi-head attention: hand-written CUDA kernels and their plain
PyTorch versions.

K1 `fused_attention` replaces the Pallas kernel
`gpv_tpu/ops/attention.py:fused_attention` (cell `_attend_cell`, masks from
`attention_mask`); K2 `fused_biattention` replaces
`gpv_tpu/ops/attention.py:fused_biattention` (`_make_biattn_kernel`). Both
kernels live in `gpv_tpu_torch/csrc/attention.cu`.

What bounds them on the H100: at every main-path shape (Tk <= 300,
Dh <= 96) the work is far below the card's ~295 operations per byte, so
the least time is set by the bytes of q, k, v and the output; an unfused
attention also moves the (B, H, Tq, Tk) fp32 score matrix through device
memory several times. The kernels keep scores and softmax statistics
on-chip (online softmax over key tiles streamed through shared memory),
so device memory sees q, k, v and out once per query tile. Their products
run on the CUDA cores in fp32, which is what keeps them above that bound.

Device policy: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises. Masks are passed as (B, Tk) key validity plus a
`causal` flag and applied as additive -1e9, as the TPU kernels do; nothing
materialises a (B, Tq, Tk) mask. Both kernels are forward-only, like the
TPU originals.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _cuda

NEG = -1e9
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int


def _mask(key_valid: Optional[torch.Tensor], causal: bool, Tq: int,
          Tk: int, device) -> Optional[torch.Tensor]:
    """Additive fp32 mask broadcastable to (B, 1, Tq, Tk): causal term plus
    key-validity term, summed before it meets the scores (as
    `gpv_tpu.ops.attention.attention_mask` builds it)."""
    mask = None
    if causal:
        keep = torch.ones(Tq, Tk, dtype=torch.bool, device=device).tril()
        mask = torch.where(keep, 0.0, NEG)[None, None]
    if key_valid is not None:
        kv = torch.where(key_valid, 0.0, NEG)[:, None, None, :]
        mask = kv if mask is None else mask + kv
    return mask


def attend_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 key_valid: Optional[torch.Tensor] = None,
                 causal: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K1, the TPU cell's arithmetic step by step:
    fp32 scores of pre-scaled q, additive -1e9 mask, max-subtracted softmax,
    P cast to v's dtype, fp32 P.V, output in q's dtype."""
    Dh = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * (1.0 / Dh ** 0.5),
                     k.float())
    mask = _mask(key_valid, causal, q.shape[1], k.shape[1], q.device)
    if mask is not None:
        s = s + mask
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float())
    return out.to(q.dtype)


def biattend_plain(q1, k1, v1, q2, k2, v2, valid1=None, valid2=None):
    """Plain PyTorch version of K2: (ctx1 (B,T2,H,Dh), ctx2 (B,T1,H,Dh))."""
    return (attend_plain(q2, k1, v1, valid1),
            attend_plain(q1, k2, v2, valid2))


def _lib() -> ctypes.CDLL:
    lib = _cuda.load("attention")
    if lib.gpv_fused_attention.argtypes is None:
        lib.gpv_fused_attention.argtypes = [_P] * 5 + [_I] * 7 + [_P]
        lib.gpv_fused_attention.restype = _I
        lib.gpv_fused_biattention.argtypes = [_P] * 10 + [_I] * 6 + [_P]
        lib.gpv_fused_biattention.restype = _I
    return lib


def _check(name: str, device, dtype, tensors: dict, shapes: dict,
           valids: dict) -> None:
    """Raise on anything the kernel does not take."""
    if device.type != "cuda":
        raise ValueError(f"{name}: tensors on {device}; the kernel takes "
                         "CUDA tensors (CPU tensors take the plain version)")
    if dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {dtype} not supported "
                        f"(one of {sorted(map(str, _DTYPES))})")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in tensors.values()):
        raise RuntimeError(f"{name} is forward-only: call it under "
                           "torch.no_grad() / torch.inference_mode()")
    for key, t in tensors.items():
        if t.device != device or t.dtype != dtype:
            raise ValueError(f"{name}: {key} is {t.dtype} on {t.device}, "
                             f"expected {dtype} on {device}")
        if tuple(t.shape) != shapes[key]:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {shapes[key]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    for key, (t, shape) in valids.items():
        if t is None:
            continue
        if (t.dtype != torch.bool or t.device != device
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name}: {key} must be a contiguous bool "
                             f"{shape} tensor on {device}")
    if next(iter(shapes.values()))[-1] > 128:
        raise ValueError(f"{name}: head dim above 128 is not supported")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_valid: Optional[torch.Tensor] = None,
                    causal: bool = False) -> torch.Tensor:
    """K1: q (B,Tq,H,Dh), k/v (B,Tk,H,Dh), key_valid (B,Tk) bool (True =
    valid) or None, causal (query i sees keys j <= i). Returns (B,Tq,H,Dh)
    in q's dtype. CPU tensors take `attend_plain`."""
    if q.device.type == "cpu":
        return attend_plain(q, k, v, key_valid, causal)
    B, Tq, H, Dh = q.shape
    Tk = k.shape[1]
    _check("fused_attention", q.device, q.dtype,
           {"q": q, "k": k, "v": v},
           {"q": (B, Tq, H, Dh), "k": (B, Tk, H, Dh), "v": (B, Tk, H, Dh)},
           {"key_valid": (key_valid, (B, Tk))})
    if causal and Tq != Tk:
        raise ValueError("fused_attention: causal needs Tq == Tk")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().gpv_fused_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_valid),
        out.data_ptr(), B, Tq, Tk, H, Dh, int(causal), _DTYPES[q.dtype],
        stream)
    if err:
        raise RuntimeError(f"fused_attention kernel: cudaError_t {err}")
    fused_attention.launches += 1
    return out


fused_attention.launches = 0


def fused_biattention(q1, k1, v1, q2, k2, v2,
                      valid1: Optional[torch.Tensor] = None,
                      valid2: Optional[torch.Tensor] = None):
    """K2: both ViLBERT directions in one launch. Stream s has q_s/k_s/v_s
    (B,T_s,H,Dh) and optional key validity valid_s (B,T_s).
    Returns ctx1 = softmax(q2 k1^T + m1) v1 (B,T2,H,Dh) and
    ctx2 = softmax(q1 k2^T + m2) v2 (B,T1,H,Dh). CPU tensors take
    `biattend_plain`."""
    if q1.device.type == "cpu":
        return biattend_plain(q1, k1, v1, q2, k2, v2, valid1, valid2)
    B, T1, H, Dh = q1.shape
    T2 = q2.shape[1]
    s1, s2 = (B, T1, H, Dh), (B, T2, H, Dh)
    _check("fused_biattention", q1.device, q1.dtype,
           {"q1": q1, "k1": k1, "v1": v1, "q2": q2, "k2": k2, "v2": v2},
           {"q1": s1, "k1": s1, "v1": s1, "q2": s2, "k2": s2, "v2": s2},
           {"valid1": (valid1, (B, T1)), "valid2": (valid2, (B, T2))})
    ctx1 = torch.empty_like(q2)
    ctx2 = torch.empty_like(q1)
    stream = torch.cuda.current_stream(q1.device).cuda_stream
    err = _lib().gpv_fused_biattention(
        q1.data_ptr(), k1.data_ptr(), v1.data_ptr(), q2.data_ptr(),
        k2.data_ptr(), v2.data_ptr(), _ptr(valid1), _ptr(valid2),
        ctx1.data_ptr(), ctx2.data_ptr(), B, T1, T2, H, Dh,
        _DTYPES[q1.dtype], stream)
    if err:
        raise RuntimeError(f"fused_biattention kernel: cudaError_t {err}")
    fused_biattention.launches += 1
    return ctx1, ctx2


fused_biattention.launches = 0
