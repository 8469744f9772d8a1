"""Fused multi-head attention: hand-written CUDA kernels and their plain
PyTorch versions.

K1 `fused_attention` replaces the Pallas kernel
`gpv_tpu/ops/attention.py:fused_attention` (cell `_attend_cell`, masks from
`attention_mask`); K2 `fused_biattention` replaces
`gpv_tpu/ops/attention.py:fused_biattention` (`_make_biattn_kernel`). Each
call goes to one of four kernel variants, chosen by `_plan` from its
dtype and shape:
- `tile` (`csrc/attention_tile.cu`): bf16 with two or more query rows, and
  both directions of K2 in one launch. Tensor-core products (mma.sync
  m16n8k16) over K/V tiles streamed through shared memory, FlashAttention-2
  style.
- `decode` (`csrc/attention_decode.cu`): bf16 with one query row, the text
  decoder's step. One block per (batch, head) whose warps split the keys.
- `fp32_tile` and `fp32_decode` (`csrc/attention.cu`): every fp32 call,
  the card's parity path (fp32 FMAs on the CUDA cores, no TF32).
  `fp32_decode` takes K1 calls of at most `FP32_DECODE_TQ` query rows
  (the decode step, the beam's K rows), and of at most
  `FP32_DECODE_LONG_TQ` over more than one 64-key tile: one block per
  (batch, head, 8 query rows) whose warps split the keys. `fp32_tile`
  takes the others and both directions of K2: 64 (or 32) query rows a
  block, K/V tiles of 64 keys double buffered, register-blocked
  products for S and P.V.

Every variant takes any head dim up to 2048 (the JAX package's einsum
path and Pallas cell take any). Up to Dh 128 a block holds all of a
head's dims. Above it every variant runs on a thread-block cluster
(`Plan.cluster` CTAs, at most 16): each CTA holds Q, K and V over its
slice of `Plan.cols` <= 128 head dims and computes O's columns of that
slice; per key tile the CTAs sum their partial scores through distributed
shared memory, so S is computed once and K and V read once, and a CTA's
shared memory does not grow with Dh. No call goes to SDPA or to the plain
version instead.

What bounds them on the H100: in bf16 at every main-path shape (Tk <= 300,
Dh <= 96) the work is far below the card's ~295 operations per byte, so
the least time is set by the bytes of q, k, v and the output. In fp32 the
products run at the CUDA cores' 67 TFLOP/s, and the shapes with Tq and Tk
of 100 or more are bound by operations. The kernels keep scores and
softmax statistics on-chip, so device memory sees q, k, v and out once
per query block.

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

from typing import NamedTuple, Optional

import torch

from . import _cuda

NEG = -1e9
_DTYPES = (torch.float32, torch.bfloat16)
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
    memory tile, the block's dynamic shared memory in bytes, for the fp32
    kernels the query rows a block owns (the bf16 kernels derive theirs
    from `warps`) and, above Dh 128, the head dims one CTA of a cluster
    holds (`cols`, 0: all of them) and the cluster's CTAs (`cluster`, 0
    up to Dh 128)."""
    variant: str  # "tile", "decode", "fp32_tile" or "fp32_decode"
    warps: int
    key_tile: int
    smem_bytes: int
    rows: int = 0
    cols: int = 0
    cluster: int = 0


# K1 fp32 calls take the decode variant at up to FP32_DECODE_TQ query rows,
# and at up to FP32_DECODE_LONG_TQ against more than one 64-key tile (where
# the tile variant would walk the tiles in series for a few rows); above Dh
# 128 those teacher-forced rows take 2 warps a CTA (measured on the H100:
# PERF.md)
FP32_DECODE_TQ, FP32_DECODE_LONG_TQ = 8, 32
KEY_TILE = 64  # keys a shared-memory tile of the tile variants
# fp32 tile CTAs of a cluster: 32-key tiles and 32 rows (two CTAs an SM)
CLUSTER_KEY_TILE = CLUSTER_ROWS = 32
WARP_KEYS = 32  # keys a warp of the decode variants scores at once
MAX_COLS = 128  # head dims one CTA holds at most (`kMaxCols`)
MAX_CLUSTER = 16  # CTAs a cluster at most (`kMaxCluster`)


def _ceil(a: int, b: int) -> int:
    return -(-a // b) * b


def _row_bytes(d: int) -> int:
    """Bytes of one shared-memory row of d bf16 values: 16-byte chunks,
    an odd number of them (`row_chunks` in csrc/attention_common.cuh)."""
    return (-(-d // 8) | 1) * 16


def _row_floats(d: int) -> int:
    """Floats of one fp32 shared-memory row of d values: 16-byte chunks,
    an odd number of them (`row_floats` in csrc/attention.cu)."""
    return (-(-d // 4) | 1) * 4


def _cols(Dh: int) -> int:
    """Head dims one CTA of a cluster holds above Dh 128 (0 below): the
    head dim split into the fewest slices of at most 128, evened out and
    rounded up to 16 (the bf16 tile kernel's product depth)."""
    if Dh <= MAX_COLS:
        return 0
    return _ceil(-(-Dh // -(-Dh // MAX_COLS)), 16)


def _cluster(Dh: int, cols: int) -> int:
    """CTAs of a head's cluster (`cluster_size`): 0 up to Dh 128; raises
    above the MAX_CLUSTER one H100 cluster may hold (Dh 2048)."""
    if not cols:
        return 0
    n = -(-Dh // cols)
    if n > MAX_CLUSTER:
        raise ValueError(f"head dim {Dh}: a cluster of {n} CTAs of {cols} "
                         f"head dims, above the {MAX_CLUSTER} one H100 "
                         "cluster may hold")
    return n


def _plan_fp32(Tq: int, Tk: int, Dh: int, both: bool) -> Plan:
    """csrc/attention.cu: `decode_smem_bytes` and `tile_smem_bytes`, over
    Dh, or above Dh 128 over one CTA's `cols` with the cluster's partial
    scores."""
    cols = _cols(Dh)
    n = _cluster(Dh, cols)
    w = cols or Dh  # head dims a block holds
    f = _row_floats(w)
    forced = Tq > FP32_DECODE_TQ  # teacher-forced rows over a long memory
    decode = not forced or (Tq <= FP32_DECODE_LONG_TQ and Tk > KEY_TILE)
    if decode and not both:  # a lane a key, no 16-row slots
        rows = min(8, 1 << (Tq - 1).bit_length())  # 8 rows a block at most
        warps = min(2 if forced and n else 4, -(-Tk // WARP_KEYS))
        return Plan("fp32_decode", warps, WARP_KEYS,  # q, part, K and V
                    4 * (rows * _ceil(w, 4) + 2 * warps * WARP_KEYS * f
                         + (warps * rows * WARP_KEYS if n else 0)),
                    rows, cols, n)
    # 16 row groups of 8 lanes; K2's short direction wastes less at 32
    rows = CLUSTER_ROWS if n else 32 if Tq <= 32 or both else 64
    keys = CLUSTER_KEY_TILE if n else KEY_TILE
    return Plan("fp32_tile", 4, keys,  # key mask, Q, K, V x 2, P, part
                4 * (keys + rows * f + 4 * keys * f + rows * (keys + 8)
                     + (rows * keys if n else 0)),
                rows, cols, n)


def _plan(dtype, Tq: int, Tk: int, Dh: int, both: bool = False) -> Plan:
    """The kernel and launch shape for one call (`both`: a K2 call, whose
    Tq is the longer stream). Mirrors the byte counts of the CUDA sources
    (`tile_smem_bytes`, `decode_smem_bytes`), which refuse a launch given
    less. Above Dh 128 every variant runs on a cluster of `cluster` CTAs
    of `cols` head dims each, whose shared memory is a Dh-128 block's plus
    its partial scores: every Dh up to 2048 plans."""
    if Dh < 1:
        raise ValueError(f"head dim {Dh}")
    if dtype == torch.float32:
        return _plan_fp32(Tq, Tk, Dh, both)
    if dtype != torch.bfloat16:
        raise TypeError(f"dtype {dtype} not supported "
                        f"(one of {sorted(map(str, _DTYPES))})")
    cols = _cols(Dh)
    n = _cluster(Dh, cols)
    if Tq == 1 and not both:  # a warp scores one key a lane
        warps = min(4, -(-Tk // WARP_KEYS))
        w = cols or Dh
        return Plan("decode", warps, WARP_KEYS,  # q in fp32, (max, sum,
                    # acc), partial scores, K and V
                    4 * max(128, _ceil(w, 8))
                    + _ceil(4 * warps * (_ceil(w, 8) + 2), 16)
                    + (warps * WARP_KEYS * 4 if n else 0)
                    + warps * WARP_KEYS * 2 * _row_bytes(w), 0, cols, n)
    warps = min(4, -(-Tq // 16))  # 16 rows a warp
    row = _row_bytes(cols or _ceil(Dh, 16))  # a Q, K or V row
    return Plan("tile", warps, KEY_TILE,  # key mask, Q rows, K and V x 2,
                # each thread's partial scores
                2 * KEY_TILE * 4 + 16 * warps * row + 4 * KEY_TILE * row
                + (warps * 32 * KEY_TILE // 2 * 4 if n else 0),
                0, cols, n)


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


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_valid: Optional[torch.Tensor] = None,
                    causal: bool = False) -> torch.Tensor:
    """K1: q (B,Tq,H,Dh), k/v (B,Tk,H,Dh), key_valid (B,Tk) bool (True =
    valid) or None, causal (query i sees keys j <= i). Returns (B,Tq,H,Dh)
    in q's dtype. CPU tensors take `attend_plain`; traced code the op
    `gpv::fused_attention`."""
    if _cuda.traced(q):
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
    if plan.variant.startswith("fp32"):
        err = _cuda.load("attention").gpv_attn_fp32(
            *ptrs, B, Tq, Tk, H, Dh, int(causal), plan.rows, plan.warps,
            plan.key_tile, plan.cols, plan.smem_bytes, stream)
    elif plan.variant == "tile":
        err = _cuda.load("attention_tile").gpv_attn_tile(
            *ptrs, B, Tq, Tk, H, Dh, int(causal), plan.warps, plan.key_tile,
            plan.cols, plan.smem_bytes, stream)
    else:
        err = _cuda.load("attention_decode").gpv_attn_decode(
            *ptrs, B, Tk, H, Dh, int(causal), plan.warps, plan.cols,
            plan.smem_bytes, stream)
    _raise_on(f"fused_attention ({plan.variant})", err)
    _cuda.count_launch(fused_attention, plan.variant)
    return out


fused_attention.launches = 0
fused_attention.variant_launches = dict.fromkeys(
    ("tile", "decode", "fp32_tile", "fp32_decode"), 0)


def fused_biattention(q1, k1, v1, q2, k2, v2,
                      valid1: Optional[torch.Tensor] = None,
                      valid2: Optional[torch.Tensor] = None):
    """K2: both ViLBERT directions in one launch. Stream s has q_s/k_s/v_s
    (B,T_s,H,Dh) and optional key validity valid_s (B,T_s).
    Returns ctx1 = softmax(q2 k1^T + m1) v1 (B,T2,H,Dh) and
    ctx2 = softmax(q1 k2^T + m2) v2 (B,T1,H,Dh). CPU tensors take
    `biattend_plain`; traced code the op `gpv::fused_biattention`."""
    if _cuda.traced(q1):
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
    if plan.variant == "fp32_tile":
        err = _cuda.load("attention").gpv_attn_fp32_bi(
            *ptrs, B, T1, T2, H, Dh, plan.rows, plan.warps, plan.key_tile,
            plan.cols, plan.smem_bytes, stream)
    else:
        err = _cuda.load("attention_tile").gpv_attn_tile_bi(
            *ptrs, B, T1, T2, H, Dh, plan.warps, plan.key_tile, plan.cols,
            plan.smem_bytes, stream)
    _raise_on(f"fused_biattention ({plan.variant})", err)
    _cuda.count_launch(fused_biattention, plan.variant)
    return ctx1, ctx2


fused_biattention.launches = 0
fused_biattention.variant_launches = dict.fromkeys(("tile", "fp32_tile"), 0)


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
