#!/usr/bin/env python3
"""Time the port's attention kernels of two checkouts on one card, in turns.

    python3 compare_kernel_times.py BASE [OTHER] [--out PATH]

BASE and OTHER are roots of checkouts (OTHER: this file's directory). Each
side runs as a fresh process (so it imports its own `gpv_tpu_torch` and
`chip_smoke.py`), in the order base, other, other, base. A side times every
K1 and K2 case of its `chip_smoke.path_cases()`, in fp32 (TF32 off) and
bf16, with its `chip_smoke.device_ms` (a CUDA-graph replay of 30
launches). Printed: per dtype, for the narrow cases (head dim up to 128)
and apart for the wide ones (above 128), the median, least and largest
ratio other / base of the cases both sides have (each side's two runs
averaged) and the base's own spread; and each wide case's ratio.
`--out` writes every time (us per launch).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path


def time_side(root: Path) -> dict:
    """{narrow|wide/case/dtype: device us per launch} of the checkout at
    `root`."""
    sys.path.insert(0, str(root))
    import torch
    import chip_smoke as cs
    from gpv_tpu_torch.ops import _cuda
    from gpv_tpu_torch.ops import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda.build_all()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            for c in cs.k1_cases():
                q, k, v = (torch.randn(c.b, t, c.h, c.dh, device=dev,
                                       generator=g).to(dtype)
                           for t in (c.tq, c.tk, c.tk))
                kv = cs._valid(c.mask, c.b, c.tk, dev, g)
                ms, _ = cs.device_ms(
                    lambda: A.fused_attention(q, k, v, kv, c.causal))
                out[f"{_kind(c.dh)}/{c.name}/{dn}"] = 1e3 * ms
            for c, has1, has2 in cs._k2_runs():
                xs = [torch.randn(c.b, t, c.h, c.dh, device=dev,
                                  generator=g).to(dtype)
                      for t in (c.tk,) * 3 + (c.tq,) * 3]
                v1 = cs._valid("query", c.b, c.tk, dev, g) if has1 else None
                v2 = cs._valid("random", c.b, c.tq, dev, g) if has2 else None
                ms, _ = cs.device_ms(
                    lambda: A.fused_biattention(*xs, v1, v2))
                name = f"masks_{int(has1)}{int(has2)}{c.name[8:]}"
                out[f"{_kind(c.dh)}/{name}/{dn}"] = 1e3 * ms
    return out


def _kind(dh: int) -> str:
    return "narrow" if dh <= 128 else "wide"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("base", type=Path)
    ap.add_argument("other", type=Path, nargs="?",
                    default=Path(__file__).resolve().parent)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--side", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.side:  # one side, in its own process
        print(json.dumps(time_side(args.side.resolve())))
        return
    runs = []
    for root in (args.base, args.other, args.other, args.base):
        res = subprocess.run([sys.executable, __file__, str(root), "--side",
                              str(root)], capture_output=True, text=True,
                             check=True)
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
    both = [k for k in runs[0] if all(k in r for r in runs)]
    ratio = {k: (runs[1][k] + runs[2][k]) / (runs[0][k] + runs[3][k])
             for k in both}
    summary = {}
    for kind in ("narrow", "wide"):
        for dtype in ("float32", "bfloat16"):
            keys = [k for k in both
                    if k.startswith(kind + "/") and k.endswith("/" + dtype)]
            if not keys:
                continue
            r = [ratio[k] for k in keys]
            spread = [abs(runs[0][k] - runs[3][k]) / runs[0][k]
                      for k in keys]
            summary[f"{kind}/{dtype}"] = {
                "cases": len(keys), "median_ratio": statistics.median(r),
                "min_ratio": min(r), "max_ratio": max(r),
                "base_spread_median": statistics.median(spread)}
    print(json.dumps(summary))
    print(json.dumps({k[len("wide/"):]: round(v, 3) for k, v in ratio.items()
                      if k.startswith("wide/")}))
    if args.out:
        args.out.write_text(json.dumps({"summary": summary, "runs": runs},
                                       indent=0))


if __name__ == "__main__":
    main()
