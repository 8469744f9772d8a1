"""Closed-loop batched prediction (`drivers/predict.py`, run as it is: the
same window, metrics, trace and check), and after it a check of each
multi-scale deformable attention layer of the program.

The answers, boxes and relevance that `judge.readings` compares lie past
six encoder and six decoder layers of bf16 rounding each, which swamps a
fault confined to the deformable sampling: its value or its weights
computed in float8 move the boxes no more than a second sound seed does.
So once the window and `predict.py`'s check are over, the program's
engine answers one more call of B images (a seeded batch of the pool's
kind), and every deformable attention layer it ran is held against the
family reference's layer (`reference/gpv_deform.py` `msdeform_attn`) on
the layer's own inputs as the program received them, for the first
`layer_rows` images:

- `msdeform_err`: over the layers, the largest of the 99th percentile of
  the program's output's distance from the reference's in fp32, over the
  same percentile of the reference's own distance when it computes in
  bfloat16 (`Precision`). A layer that computes as the configuration
  states reads about 1 (the program rounds what it stores; the
  reference's bfloat16 only its products' operands); float8 operands
  read several times that.
- with the run's `control`, `control_msdeform_err`: the same of the
  reference computed in float8.

The program's layers are the modules that hold the published parts of
`MSDeformAttn` (`sampling_offsets`, `attention_weights`, `value_proj`,
`output_proj`), named as their weights are, whose forward takes (query,
ref, value_in, shapes, value_valid); a program with none reads inf.
Traffic parameters: `predict.py`'s, and `layer_rows`.
"""
from __future__ import annotations

import inspect
import math
from pathlib import Path

from gpvbench import build, family
from gpvbench.run import load_file

_predict = load_file(Path(__file__).with_name("predict.py"),
                     "gpvbench_driver_predict")
PARTS = ("sampling_offsets", "attention_weights", "value_proj",
         "output_proj")
ARGS = ("query", "ref", "value_in", "shapes", "value_valid")


def deform_layers(model) -> dict:
    """{name: module} of the program's deformable attention layers."""
    import torch
    return {name: m for name, m in model.named_modules()
            if all(isinstance(getattr(m, p, None), torch.nn.Module)
                   for p in PARTS)}


def capture(layers: dict, rows: int):
    """Forward hooks that keep each layer's inputs and output of its first
    `rows` images (fp32 copies, the last call's); returns ({name: record},
    the hooks' handles)."""
    seen, handles = {}, []

    def keep(name, sig):
        def hook(mod, args, kwargs, out):
            a = sig.bind(*args, **kwargs).arguments
            valid = a.get("value_valid")
            seen[name] = {
                "query": a["query"][:rows].detach().float(),
                "ref": a["ref"][:rows].detach().float(),
                "value_in": a["value_in"][:rows].detach().float(),
                "shapes": [tuple(int(x) for x in s) for s in a["shapes"]],
                "valid": None if valid is None else valid[:rows].detach(),
                "out": out[:rows].detach().float()}
        return hook

    for name, mod in layers.items():
        sig = inspect.signature(mod.forward)
        missing = [p for p in ARGS if p not in sig.parameters]
        if missing:
            raise TypeError(f"{name}: its forward takes no {missing}")
        handles.append(mod.register_forward_hook(keep(name, sig),
                                                 with_kwargs=True))
    return seen, handles


def _p99(x) -> float:
    x = x.flatten().float()
    return float(x.kthvalue(max(1, math.ceil(0.99 * x.numel()))).values)


def layer_readings(ref, W, model: dict, seen: dict, control: bool,
                   block: int = 4) -> dict:
    """`msdeform_err` (and `control_msdeform_err`) of the captured layers
    (module docstring), the reference run in blocks of `block` images."""
    import torch
    if not seen:
        out = {"msdeform_err": float("inf")}
        if control:
            out["control_msdeform_err"] = float("inf")
        return out
    heads = int(model["detr"]["nheads"])
    precisions = {"32": ref.Precision("float32"),
                  "16": ref.Precision("bfloat16")}
    if control:
        precisions["8"] = ref.Precision("float8")
    out = {"msdeform_err": 0.0}
    if control:
        out["control_msdeform_err"] = 0.0
    for name, rec in seen.items():
        levels = len(rec["shapes"])
        points = W[f"{name}.attention_weights.weight"].shape[0] // (
            heads * levels)
        valid = rec["valid"]
        if valid is None:
            valid = torch.ones(rec["value_in"].shape[:2], dtype=torch.bool,
                               device=rec["value_in"].device)
        got = {k: [] for k in precisions}
        for s in range(0, rec["query"].shape[0], block):
            part = slice(s, s + block)
            for k, P in precisions.items():
                got[k].append(ref.msdeform_attn(
                    P, W, name, rec["query"][part], rec["ref"][part],
                    rec["value_in"][part], rec["shapes"], valid[part],
                    heads, levels, points))
        r32 = torch.cat(got.pop("32"))
        scale = max(_p99((torch.cat(got["16"]) - r32).abs()), 1e-30)
        out["msdeform_err"] = max(out["msdeform_err"],
                                  _p99((rec["out"] - r32).abs()) / scale)
        if control:
            out["control_msdeform_err"] = max(
                out["control_msdeform_err"],
                _p99((torch.cat(got["8"]) - r32).abs()) / scale)
    return out


def run(ctx) -> dict:
    import time

    import numpy as np
    import torch
    held = {}
    make = build.make_engine

    def keep(c):
        held["eng"] = make(c)
        return held["eng"]

    build.make_engine = keep
    try:
        result = _predict.run(ctx)
    finally:
        build.make_engine = make
    eng = held.pop("eng")
    t = time.perf_counter()
    B = int(ctx.traffic["batch"])
    pool = build.Pool(ctx, 1, B)
    queries = pool.queries(np.random.default_rng(build.seed_of(ctx.seed, 5)),
                           B)
    seen, handles = capture(deform_layers(eng.model),
                            int(ctx.traffic["layer_rows"]))
    try:
        eng.predict(pool.images[0], queries)
    finally:
        for h in handles:
            h.remove()
    del eng
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = family.reference(ctx.config)
    with torch.no_grad():
        result["readings"].update(layer_readings(
            ref, build.seeded_weights(ctx), ctx.model, seen, ctx.control))
    ctx.log(f"gpvbench: {len(seen)} deformable layers against the "
            f"reference {time.perf_counter() - t:.3f} s")
    return result
