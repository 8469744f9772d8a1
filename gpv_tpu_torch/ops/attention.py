"""Fused multi-head attention: hand-written CUDA kernels and their plain
PyTorch versions.

K1 `fused_attention` replaces the Pallas kernel
`gpv_tpu/ops/attention.py:fused_attention` (cell `_attend_cell`, masks from
`attention_mask`); K2 `fused_biattention` replaces
`gpv_tpu/ops/attention.py:fused_biattention` (`_make_biattn_kernel`). Each
call goes to one of three kernels, chosen by `_plan` from its dtype and
shape:
- `tile` (`csrc/attention_tile.cu`): bf16 with two or more query rows, and
  both directions of K2 in one launch. Tensor-core products (mma.sync
  m16n8k16) over K/V tiles streamed through shared memory, FlashAttention-2
  style.
- `decode` (`csrc/attention_decode.cu`): bf16 with one query row, the text
  decoder's step. One block per (batch, head) whose warps split the keys.
- `fp32` (`csrc/attention.cu`): every fp32 call, the card's parity path
  (full fp32 on the CUDA cores).

What bounds them on the H100: at every main-path shape (Tk <= 300,
Dh <= 96) the work is far below the card's ~295 operations per byte, so
the least time is set by the bytes of q, k, v and the output; an unfused
attention also moves the (B, H, Tq, Tk) fp32 score matrix through device
memory several times. The kernels keep scores and softmax statistics
on-chip, so device memory sees q, k, v and out once per query block.

Device policy: a CPU tensor takes the plain version; a CUDA tensor launches
a kernel or raises. Masks are passed as (B, Tk) key validity plus a
`causal` flag and applied as additive -1e9, as the TPU kernels do; nothing
materialises a (B, Tq, Tk) mask. Both kernels are forward-only, like the
TPU originals.

Both wrappers are also torch ops, `gpv::fused_attention` and
`gpv::fused_biattention` (`torch.library.custom_op`: the CUDA kernel is
the launch above, the CPU kernel the plain version, a fake kernel gives
the outputs' shapes), so `torch.export` and `torch.compile` see one node
where they cannot trace a ctypes launch. Only traced code goes through the
op: an eager call takes the wrapper's direct path, because the op's
dispatch adds host time to every call (PERF.md). The ops are forward-only:
no autograd formula is registered.
"""
from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional

import torch

from . import _cuda

NEG = -1e9
_DTYPES = (torch.float32, torch.bfloat16)
_P, _I = ctypes.c_void_p, ctypes.c_int
ALIGN = 16  # bytes: the kernels copy 16-byte chunks


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


class Plan(NamedTuple):
    """How one call runs: the kernel, warps per block, keys per shared-
    memory tile and the block's dynamic shared memory in bytes."""
    variant: str  # "tile", "decode" or "fp32"
    warps: int
    key_tile: int
    smem_bytes: int


def _row_bytes(d: int) -> int:
    """Bytes of one shared-memory row of d bf16 values: 16-byte chunks,
    an odd number of them (`row_chunks` in csrc/attention_common.cuh)."""
    return ((d // 8) | 1) * 16


def _plan(dtype, Tq: int, Tk: int, Dh: int, both: bool = False) -> Plan:
    """The kernel and launch shape for one call (`both`: a K2 call, whose
    Tq is the longer stream). Mirrors the byte counts of the CUDA sources
    (`tile_smem_bytes`, `decode_smem_bytes`), which refuse a launch given
    less."""
    if dtype == torch.float32:  # csrc/attention.cu: static shared memory
        return Plan("fp32", 4, 32, 0)
    if dtype != torch.bfloat16:
        raise TypeError(f"dtype {dtype} not supported "
                        f"(one of {sorted(map(str, _DTYPES))})")
    if Dh % 8 or not 0 < Dh <= 128:
        raise ValueError(f"bf16 head dim {Dh}: the kernels take multiples "
                         "of 8 up to 128")
    if Tq == 1 and not both:  # a warp scores one key a lane
        keys = 32
        warps = min(4, -(-Tk // keys))
        part = -(-(4 * warps * (Dh + 2)) // 16) * 16  # (max, sum, acc)
        return Plan("decode", warps, keys,  # q in fp32, then K and V rows
                    4 * 128 + part + warps * 2 * keys * _row_bytes(Dh))
    keys, warps = 64, min(4, -(-Tq // 16))  # a warp owns 16 query rows
    row = _row_bytes(-(-Dh // 16) * 16)
    return Plan("tile", warps, keys,  # key mask, Q rows, K and V x 2 stages
                2 * keys * 4 + 16 * warps * row + 2 * 2 * keys * row)


_SIGNATURES = {  # source -> {function: argtypes}; each returns cudaError_t
    "attention": {"gpv_attn_fp32": [_P] * 5 + [_I] * 6 + [_P],
                  "gpv_attn_fp32_bi": [_P] * 10 + [_I] * 5 + [_P]},
    "attention_tile": {"gpv_attn_tile_init": [],
                       "gpv_attn_tile": [_P] * 5 + [_I] * 8 + [_P],
                       "gpv_attn_tile_bi": [_P] * 10 + [_I] * 7 + [_P]},
    "attention_decode": {"gpv_attn_decode_init": [],
                         "gpv_attn_decode": [_P] * 5 + [_I] * 7 + [_P]},
}
_ready: dict = {}
_count_lock = threading.Lock()


def _lib(source: str) -> ctypes.CDLL:
    """The loaded library of csrc/<source>.cu, its functions typed and its
    `*_init` (the kernels' shared-memory limits) run once."""
    lib = _ready.get(source)
    if lib is None:
        lib = _cuda.load(source)
        for fn, argtypes in _SIGNATURES[source].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _I
            if fn.endswith("_init"):
                _raise_on(fn, getattr(lib, fn)())
        _ready[source] = lib
    return lib


def _raise_on(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name} kernel: cudaError_t {err}")


def _aligned(name: str, tensors: dict) -> None:
    """Raise unless every tensor's data starts on a 16-byte boundary (the
    kernels copy 16-byte chunks). A pure check of the tensors."""
    for key, t in tensors.items():
        off = t.data_ptr() % ALIGN
        if off:
            raise ValueError(f"{name}: {key} starts {off} bytes past a "
                             f"{ALIGN}-byte boundary; the kernels need "
                             "aligned tensors (a view into another "
                             "tensor's storage may not be)")


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


def _count(wrapper, variant: str) -> None:
    """One launch of `variant` on `wrapper`'s counters, under a lock: the
    serving workers launch from several threads."""
    with _count_lock:
        wrapper.launches += 1
        wrapper.variant_launches[variant] += 1


def _traced(t: torch.Tensor) -> bool:
    """True while torch.export or torch.compile traces the caller (the
    tensors are fake, or dynamo runs): the call must become an op node."""
    return torch.compiler.is_compiling() or type(t) is not torch.Tensor


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_valid: Optional[torch.Tensor] = None,
                    causal: bool = False) -> torch.Tensor:
    """K1: q (B,Tq,H,Dh), k/v (B,Tk,H,Dh), key_valid (B,Tk) bool (True =
    valid) or None, causal (query i sees keys j <= i). Returns (B,Tq,H,Dh)
    in q's dtype. CPU tensors take `attend_plain`; traced code the op
    `gpv::fused_attention`."""
    if _traced(q):
        return torch.ops.gpv.fused_attention(q, k, v, key_valid, causal)
    if q.device.type == "cpu":
        return attend_plain(q, k, v, key_valid, causal)
    return _launch_attention(q, k, v, key_valid, causal)


def _launch_attention(q, k, v, key_valid, causal) -> torch.Tensor:
    """K1 on CUDA tensors: check, plan, launch, count."""
    B, Tq, H, Dh = q.shape
    Tk = k.shape[1]
    _check("fused_attention", q.device, q.dtype,
           {"q": q, "k": k, "v": v},
           {"q": (B, Tq, H, Dh), "k": (B, Tk, H, Dh), "v": (B, Tk, H, Dh)},
           {"key_valid": (key_valid, (B, Tk))})
    if causal and Tq != Tk:
        raise ValueError("fused_attention: causal needs Tq == Tk")
    plan = _plan(q.dtype, Tq, Tk, Dh)
    out = torch.empty_like(q)
    _aligned("fused_attention", {"q": q, "k": k, "v": v, "out": out})
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_valid),
            out.data_ptr())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if plan.variant == "fp32":
        err = _lib("attention").gpv_attn_fp32(
            *ptrs, B, Tq, Tk, H, Dh, int(causal), stream)
    elif plan.variant == "tile":
        err = _lib("attention_tile").gpv_attn_tile(
            *ptrs, B, Tq, Tk, H, Dh, int(causal), plan.warps,
            plan.smem_bytes, stream)
    else:
        err = _lib("attention_decode").gpv_attn_decode(
            *ptrs, B, Tk, H, Dh, int(causal), plan.warps, plan.smem_bytes,
            stream)
    _raise_on(f"fused_attention ({plan.variant})", err)
    _count(fused_attention, plan.variant)
    return out


fused_attention.launches = 0
fused_attention.variant_launches = dict.fromkeys(("tile", "decode", "fp32"),
                                                 0)


def fused_biattention(q1, k1, v1, q2, k2, v2,
                      valid1: Optional[torch.Tensor] = None,
                      valid2: Optional[torch.Tensor] = None):
    """K2: both ViLBERT directions in one launch. Stream s has q_s/k_s/v_s
    (B,T_s,H,Dh) and optional key validity valid_s (B,T_s).
    Returns ctx1 = softmax(q2 k1^T + m1) v1 (B,T2,H,Dh) and
    ctx2 = softmax(q1 k2^T + m2) v2 (B,T1,H,Dh). CPU tensors take
    `biattend_plain`; traced code the op `gpv::fused_biattention`."""
    if _traced(q1):
        return torch.ops.gpv.fused_biattention(q1, k1, v1, q2, k2, v2,
                                               valid1, valid2)
    if q1.device.type == "cpu":
        return biattend_plain(q1, k1, v1, q2, k2, v2, valid1, valid2)
    return _launch_biattention(q1, k1, v1, q2, k2, v2, valid1, valid2)


def _launch_biattention(q1, k1, v1, q2, k2, v2, valid1, valid2):
    """K2 on CUDA tensors: check, plan, launch, count."""
    B, T1, H, Dh = q1.shape
    T2 = q2.shape[1]
    s1, s2 = (B, T1, H, Dh), (B, T2, H, Dh)
    _check("fused_biattention", q1.device, q1.dtype,
           {"q1": q1, "k1": k1, "v1": v1, "q2": q2, "k2": k2, "v2": v2},
           {"q1": s1, "k1": s1, "v1": s1, "q2": s2, "k2": s2, "v2": s2},
           {"valid1": (valid1, (B, T1)), "valid2": (valid2, (B, T2))})
    plan = _plan(q1.dtype, max(T1, T2), min(T1, T2), Dh, both=True)
    ctx1 = torch.empty_like(q2)
    ctx2 = torch.empty_like(q1)
    _aligned("fused_biattention",
             {"q1": q1, "k1": k1, "v1": v1, "q2": q2, "k2": k2, "v2": v2,
              "ctx1": ctx1, "ctx2": ctx2})
    ptrs = (q1.data_ptr(), k1.data_ptr(), v1.data_ptr(), q2.data_ptr(),
            k2.data_ptr(), v2.data_ptr(), _ptr(valid1), _ptr(valid2),
            ctx1.data_ptr(), ctx2.data_ptr())
    stream = torch.cuda.current_stream(q1.device).cuda_stream
    if plan.variant == "fp32":
        err = _lib("attention").gpv_attn_fp32_bi(*ptrs, B, T1, T2, H, Dh,
                                                 stream)
    else:
        err = _lib("attention_tile").gpv_attn_tile_bi(
            *ptrs, B, T1, T2, H, Dh, plan.warps, plan.smem_bytes, stream)
    _raise_on(f"fused_biattention ({plan.variant})", err)
    _count(fused_biattention, plan.variant)
    return ctx1, ctx2


fused_biattention.launches = 0
fused_biattention.variant_launches = dict.fromkeys(("tile", "fp32"), 0)


# ---- the torch ops: CUDA = the launch, CPU = the plain version ----

_attention_op = torch.library.custom_op(
    "gpv::fused_attention", _launch_attention, mutates_args=(),
    device_types="cuda",
    schema="(Tensor q, Tensor k, Tensor v, Tensor? key_valid, bool causal)"
           " -> Tensor")
_attention_op.register_kernel("cpu")(attend_plain)
_attention_op.register_fake(
    lambda q, k, v, key_valid, causal: torch.empty_like(q))

_biattention_op = torch.library.custom_op(
    "gpv::fused_biattention", _launch_biattention, mutates_args=(),
    device_types="cuda",
    schema="(Tensor q1, Tensor k1, Tensor v1, Tensor q2, Tensor k2, "
           "Tensor v2, Tensor? valid1, Tensor? valid2) -> (Tensor, Tensor)")
_biattention_op.register_kernel("cpu")(biattend_plain)
_biattention_op.register_fake(
    lambda q1, k1, v1, q2, k2, v2, valid1, valid2: (torch.empty_like(q2),
                                                    torch.empty_like(q1)))
