"""The card's published peaks and the least time a piece of work can take
on it (a frozen copy of the arithmetic `chip_smoke.py` uses for the
port's kernel table).

NVIDIA H100 SXM data sheet, dense rates without sparsity, at the full
700 W power limit: 3.35 TB/s of HBM, 989 TFLOP/s in bf16 on the tensor
cores, 67 TFLOP/s in fp32 on the CUDA cores (the fp32 kernels run with
TF32 off).
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def bound(bytes_moved: float, flops: float, dtype: str) -> dict:
    """The least time for the work: each input read once and each output
    written once at the memory rate, the multiply-adds at the peak of
    `dtype`; the larger of the two bounds."""
    t_bytes = 1e3 * bytes_moved / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / PEAK_FLOPS[dtype]
    return {"bytes": bytes_moved, "flops": flops, "bytes_ms": t_bytes,
            "ops_ms": t_ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
