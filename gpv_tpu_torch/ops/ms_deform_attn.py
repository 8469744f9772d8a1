"""Multi-scale deformable attention's sampling (Zhu et al., "Deformable
DETR", ICLR 2021, `MSDeformAttn`): a hand-written CUDA kernel
(`csrc/ms_deform_attn.cu`) and its plain PyTorch version.

For each query q and head h the op reads L x P samples of the value (L
feature levels, P points a level):

    out[b, q, h] = sum_{l, p} A[b, q, h, l, p] * bilinear(V_{b, l, h}, loc)
    A   = softmax of the L*P logits of (b, q, h)
    loc = ref[b, q, l] + off[b, q, h, l, p] / (W_l, H_l)

`loc` is (x, y) in [0, 1] of level l's map; the sample sits at pixel
(loc.x * W_l - 0.5, loc.y * H_l - 0.5) and a corner outside the map
reads 0: `grid_sample`'s bilinear mode with zero padding and
`align_corners=False`, as the published `ms_deform_attn_core_pytorch`
samples.

Arguments: `value` (B, S, H, Dh), level l's rows starting at
sum_{k<l} H_k W_k, row-major; `shapes` the L (H_l, W_l) as ints; `ref`
(B, Q, L, 2) (valid ratios applied by the caller); `off` (B, Q, H, L, P,
2) in pixels of level l; `logits` (B, Q, H, L*P). Returns (B, Q, H*Dh) in
the value's dtype. Locations, the softmax and the sums are fp32 in both
versions, whatever the inputs' dtype.

Device policy as `ops.attention`'s: a CUDA tensor launches the kernel
(variant `bf16` or `fp32`, by the value's dtype) or raises, also when an
input requires a gradient (the kernel is forward-only: training calls
`ms_deform_attn_plain` itself, as `nn.layers.attend_train` stands for
K1); a CPU tensor takes the plain version. The kernel takes a head dim
of 32 (Deformable DETR's 256 wide, 8 heads), at most 4 levels and 32
samples a head; the wrapper raises on anything else, and so does the
kernel's C entry. A launch's tile of queries, threads and shared memory
come from the pure `_plan`. `ms_deform_attn.variant_launches` counts the
kernel's launches by variant, as the attention wrappers' counters do
(inside a CUDA graph's capture, into the capture's tally).

The wrapper is also the torch op `gpv::ms_deform_attn`
(`torch.library.custom_op`: the CUDA kernel is the launch, the CPU
kernel the plain version, a fake kernel gives the output's shape), so
`torch.export` and `torch.compile` see one node that launches the kernel
on the card. As for K1 and K2, only traced code goes through the op.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _cuda

INVALID_VALUE = 1  # cudaErrorInvalidValue: the C entry's refusal
# what the kernel takes (`kDh`, `kMaxLevels`, `kMaxSamples`)
DH, MAX_LEVELS, MAX_SAMPLES = 32, 4, 32
TAKES = ("the kernel takes head dim 32, at most 4 levels and 32 samples a "
         "head, and levels that hold the value's rows")
CHUNK = 16          # bytes a thread gathers at once: 8 bf16 or 4 fp32
SLOT_BYTES = 32     # shared memory a sample: 4 value rows, 4 weights
MAX_TILE = 8        # queries a block at most
MAX_THREADS = 256   # a block's threads at most (`kMaxThreads`)
MIN_BLOCKS = 264    # two blocks for each of the H100's 132 SMs
MAX_SMEM = 232448   # shared memory an H100 block may use (`kMaxSmem`)


class Plan(NamedTuple):
    """One launch: block k samples queries [t * tile, (t + 1) * tile) of
    image k // tiles (t = k % tiles, tiles = ceil(Q / tile)), the grid
    image by image."""
    tile: int        # queries of one image a block, all heads
    threads: int
    smem_bytes: int  # SLOT_BYTES a (sample, head, query), tile + 1 queries
    blocks: int


def _plan(B: int, Q: int, S: int, H: int, L: int, P: int, dtype) -> Plan:
    """The launch for B images of Q queries over S value rows, H heads, L
    levels of P points (csrc/ms_deform_attn.cu, which refuses a launch
    given less shared memory). One rule for every shape: the largest tile
    up to MAX_TILE that still gives MIN_BLOCKS blocks and fits the
    shared memory; a thread a 16-byte chunk of a head, MAX_THREADS at
    most (a block walks the rest)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ms_deform_attn: dtype {dtype} not supported "
                        "(float32 or bfloat16)")
    if not (1 <= L <= MAX_LEVELS and P >= 1 and L * P <= MAX_SAMPLES
            and H >= 1 and S >= 1):
        raise ValueError(f"ms_deform_attn: {H} heads, {L} levels x {P} "
                         f"points over {S} value rows; {TAKES}")
    if S * H * DH * dtype.itemsize // CHUNK > 2 ** 31 - 1:
        raise ValueError(f"ms_deform_attn: {S} value rows of {H} heads "
                         "outgrow the kernel's 32-bit row offsets")

    def smem(tile):  # a slot a (sample, head, query), one spare a tile
        return L * P * H * (tile + 1) * SLOT_BYTES

    if smem(1) > MAX_SMEM:
        raise ValueError(f"ms_deform_attn: {H} heads x {L * P} samples "
                         f"take {smem(1)} bytes of shared memory at one "
                         f"query a block, above the {MAX_SMEM} a block may "
                         "use")
    tile = MAX_TILE
    while tile > 1 and (B * -(-Q // tile) < MIN_BLOCKS
                        or smem(tile) > MAX_SMEM):
        tile //= 2
    chunks = tile * H * DH * dtype.itemsize // CHUNK  # a thread's each
    return Plan(tile, min(MAX_THREADS, -(-chunks // 32) * 32), smem(tile),
                B * -(-Q // tile))


def _locations(shapes, ref, off):
    """(B, Q, H, L, P, 2) fp32 sampling locations in [0, 1]."""
    norm = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32,
                        device=ref.device)
    return (ref.float()[:, :, None, :, None, :]
            + off.float() / norm[None, None, None, :, None, :])


def ms_deform_attn_plain(value: torch.Tensor, shapes: Sequence[Tuple[int,
                                                                     int]],
                         ref: torch.Tensor, off: torch.Tensor,
                         logits: torch.Tensor) -> torch.Tensor:
    """The op in plain PyTorch: fp32 locations and softmax, one
    `grid_sample` a level over the fp32 value, the weighted sum in fp32,
    the output in the value's dtype. Differentiable."""
    B, S, H, Dh = value.shape
    Q, L, P = off.shape[1], off.shape[3], off.shape[4]
    grids = 2.0 * _locations(shapes, ref, off) - 1.0
    attn = logits.float().softmax(-1)                      # (B, Q, H, L*P)
    levels = value.float().split([h * w for h, w in shapes], dim=1)
    sampled = []
    for lvl, (h, w) in enumerate(shapes):
        v = levels[lvl].permute(0, 2, 3, 1).reshape(B * H, Dh, h, w)
        g = grids[:, :, :, lvl].transpose(1, 2).reshape(B * H, Q, P, 2)
        sampled.append(F.grid_sample(v, g, mode="bilinear",
                                     padding_mode="zeros",
                                     align_corners=False))  # (BH, Dh, Q, P)
    s = torch.stack(sampled, dim=-2).flatten(-2)           # (BH, Dh, Q, LP)
    a = attn.transpose(1, 2).reshape(B * H, 1, Q, L * P)
    out = (s * a).sum(-1).view(B, H * Dh, Q).transpose(1, 2)
    return out.to(value.dtype).contiguous()


def _check(value, shapes, ref, off, logits) -> None:
    """Raise on what the C entry cannot see: dtypes, shapes, devices,
    layout, and a gradient the kernel would not carry."""
    B, S, H, Dh = value.shape
    L = len(shapes)
    if off.dim() != 6:
        raise ValueError(f"ms_deform_attn: off has shape {tuple(off.shape)}, "
                         "expected (B, Q, H, L, P, 2)")
    Q, P = off.shape[1], off.shape[4]
    if value.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ms_deform_attn: dtype {value.dtype} not supported "
                        "(float32 or bfloat16)")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (
            value, ref, off, logits)):
        raise RuntimeError("ms_deform_attn is forward-only: call it under "
                           "torch.no_grad() / torch.inference_mode(), or "
                           "ms_deform_attn_plain to train")
    want = {"off": (off, value.dtype, (B, Q, H, L, P, 2)),
            "logits": (logits, value.dtype, (B, Q, H, L * P)),
            "ref": (ref, torch.float32, (B, Q, L, 2))}
    for key, (t, dtype, shape) in want.items():
        if t.device != value.device or t.dtype != dtype:
            raise ValueError(f"ms_deform_attn: {key} is {t.dtype} on "
                             f"{t.device}, expected {dtype} on "
                             f"{value.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"ms_deform_attn: {key} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    for key, t in (("value", value), ("off", off), ("logits", logits),
                   ("ref", ref)):
        if not t.is_contiguous():
            raise ValueError(f"ms_deform_attn: {key} must be contiguous")


def _launch(value, shapes, ref, off, logits) -> torch.Tensor:
    """The kernel on CUDA tensors: check, plan, launch, count."""
    _check(value, shapes, ref, off, logits)
    B, S, H, Dh = value.shape
    Q, L, P = off.shape[1], off.shape[3], off.shape[4]
    bf16 = value.dtype == torch.bfloat16
    variant = "bf16" if bf16 else "fp32"
    refusal = (f"ms_deform_attn ({variant}): head dim {Dh}, levels "
               f"{list(shapes)} ({L} x {P} points) over {S} value rows; "
               f"{TAKES}")
    if Dh != DH or sum(h * w for h, w in shapes) != S:
        raise ValueError(refusal)
    plan = _plan(B, Q, S, H, L, P, value.dtype)
    for key, t, align in (("value", value, CHUNK),
                          ("off", off, 2 * off.element_size())):
        if t.data_ptr() % align:
            raise ValueError(f"ms_deform_attn: {key} starts "
                             f"{t.data_ptr() % align} bytes past a "
                             f"{align}-byte boundary; the kernel reads it in "
                             f"{align}-byte pieces (a view into another "
                             "tensor's storage may not be aligned)")
    out = torch.empty(B, Q, H * Dh, dtype=value.dtype, device=value.device)
    flat = (ctypes.c_int * (2 * L))(*[int(x) for hw in shapes for x in hw])
    err = _cuda.load("ms_deform_attn").gpv_msdeform(
        value.data_ptr(), ref.data_ptr(), off.data_ptr(), logits.data_ptr(),
        out.data_ptr(), B, S, Q, H, Dh, L, P, flat, int(bf16), plan.tile,
        plan.threads, plan.smem_bytes,
        torch.cuda.current_stream(value.device).cuda_stream)
    if err == INVALID_VALUE:
        raise ValueError(refusal)
    if err:
        raise RuntimeError(f"ms_deform_attn ({variant}) kernel: "
                           f"cudaError_t {err}")
    _cuda.count_launch(ms_deform_attn, variant)
    return out


def ms_deform_attn(value: torch.Tensor, shapes: Sequence[Tuple[int, int]],
                   ref: torch.Tensor, off: torch.Tensor,
                   logits: torch.Tensor) -> torch.Tensor:
    """The op (module docstring): the kernel on CUDA tensors, the plain
    version on CPU tensors, the op `gpv::ms_deform_attn` in traced
    code."""
    shapes = [(int(h), int(w)) for h, w in shapes]
    if _cuda.traced(value):
        return torch.ops.gpv.ms_deform_attn(
            value, [x for hw in shapes for x in hw], ref, off, logits)
    if value.device.type == "cpu":
        return ms_deform_attn_plain(value, shapes, ref, off, logits)
    if value.device.type != "cuda":
        raise ValueError(f"ms_deform_attn: tensors on {value.device}; the "
                         "kernel takes CUDA tensors (CPU tensors take the "
                         "plain version)")
    return _launch(value, shapes, ref, off, logits)


ms_deform_attn.launches = 0
ms_deform_attn.variant_launches = dict.fromkeys(("bf16", "fp32"), 0)


# ---- the torch op: CUDA = the launch, CPU = the plain version ----

def _pairs(flat: Sequence[int]):
    return [(int(flat[i]), int(flat[i + 1])) for i in range(0, len(flat), 2)]


_op = torch.library.custom_op(
    "gpv::ms_deform_attn",
    lambda value, shapes, ref, off, logits: _launch(
        value, _pairs(shapes), ref, off, logits),
    mutates_args=(), device_types="cuda",
    schema="(Tensor value, int[] shapes, Tensor ref, Tensor off, "
           "Tensor logits) -> Tensor")
_op.register_kernel("cpu")(
    lambda value, shapes, ref, off, logits: ms_deform_attn_plain(
        value, _pairs(shapes), ref, off, logits))
_op.register_fake(
    lambda value, shapes, ref, off, logits: value.new_empty(
        off.shape[0], off.shape[1], value.shape[2] * value.shape[3]))
