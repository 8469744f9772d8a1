"""Headline benchmark of the port: batched GPV inference throughput on one
card (counterpart of the repository's `bench.py`).

    python -m gpv_tpu_torch.bench [batch=20] [mode=greedy|beam] [beam=5]
                                  [device=cuda|cpu] [dims=released|tiny]

It runs `bench.py`'s work on `bench.py`'s shapes: the port's `GPV` at the
widths `bench.py:86-90` builds (DETR 256 wide, 8 heads, 6 + 6 layers, 100
queries; a 10000-word answer vocabulary; answers of at most 20 tokens;
the released BERT-base, co-attention and text decoder), bf16, seeded
random weights with the frozen BN folded into the trunk's convolutions as
a server folds it; B float images of 480x640 and 12-token queries; encode,
then `greedy_decode` (19 steps) or `beam_decode` keeping the best beam,
then the boxes sorted by relevance. 30 timed iterations follow one warm-up,
each on an image buffer of its own.

`bench.py:146-155` keeps 3 results in flight: it dispatches iteration i
before a thread pool of 3 fetches iteration i-1's tokens to the host. Here
a call only enqueues work on the card's stream, so the counterpart is 3
pinned host buffers: iteration i's tokens are copied into buffer i % 3
without waiting, an event marks the copy, and the buffer's previous
tokens (iteration i - 3) are read once their event has passed. Every
iteration's tokens are read before the clock stops.

It prints exactly one JSON line with `bench.py`'s keys: `metric`
(`batched_inference_images_per_sec`, or
`batched_beam{K}_inference_images_per_sec`), `value` (images/s), `unit`,
`vs_baseline` and `baseline_estimated`, plus `device` and `power_limit_w`
as `nvidia-smi --query-gpu=name,power.limit` reads them. `vs_baseline`
divides by `bench.py`'s 45 images/s: an analytic estimate of the reference
PyTorch implementation's fp32 eval throughput on a 24 GB GPU (BASELINE.md,
"baseline denominator"), never measured, hence `baseline_estimated`.

It runs on the card; without one it raises unless given `device=cpu`.
`dims=tiny` shrinks every width and the image (the CPU test's setting);
its numbers measure nothing.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

# bench.py's constants
PYTORCH_BASELINE_IMG_PER_SEC = 45.0
BATCH, H, W, VOCAB, MAX_TEXT_LEN = 20, 480, 640, 10000, 20
QUERY_TOKENS, BERT_VOCAB = 12, 30522
N_ITERS, PIPELINE_DEPTH = 30, 3
DETR = dict(num_queries=100, num_classes=1, hidden_dim=256, nheads=8,
            num_encoder_layers=6, num_decoder_layers=6,
            dim_feedforward=2048, dropout=0.1)
# dims=tiny: every width cut, for a CPU run that checks the line only
TINY = dict(hw=(48, 64), iters=2, vocab=64, bert_vocab=100,
            model=dict(hidden_dim=32, co_att_num_layers=1, co_att_heads=4,
                       co_att_intermediate=64, text_decoder_layers=1,
                       text_decoder_heads=4, bert_layers=1, bert_hidden=32,
                       bert_heads=4),
            detr=dict(num_queries=10, num_classes=1, hidden_dim=32,
                      nheads=4, num_encoder_layers=1, num_decoder_layers=1,
                      dim_feedforward=64, dropout=0.1,
                      backbone_layers=(1, 1, 1, 1)))


def card_name_and_limit(device: torch.device):
    """(name, power limit in W) as nvidia-smi gives them for the card;
    ("cpu", None) on the CPU."""
    if device.type != "cuda":
        return "cpu", None
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    try:
        line = subprocess.run(
            ["nvidia-smi", f"--id={idx}", "--query-gpu=name,power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
        name, limit = (x.strip() for x in line.rsplit(",", 1))
        return name, float(limit)
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return torch.cuda.get_device_name(device), None


def build_model(device: torch.device, tiny: bool):
    """The bf16 GPV at bench.py's widths (or tiny ones), seeded random
    weights, BN folded, on `device`."""
    from .models.gpv import GPV
    from .ops.fold_bn import fold_frozen_bn
    from .weights import init_random
    if tiny:
        model = GPV(vocab_size=TINY["vocab"], max_text_len=MAX_TEXT_LEN,
                    detr_cfg=TINY["detr"], bert_vocab_size=TINY["bert_vocab"],
                    **TINY["model"])
    else:
        model = GPV(vocab_size=VOCAB, max_text_len=MAX_TEXT_LEN,
                    detr_cfg=DETR)
    init_random(model, seed=0).eval().requires_grad_(False)
    fold_frozen_bn(model.detr.trunk)
    return model.to(device=device, dtype=torch.bfloat16)


def infer(model, images, query_ids, query_valid, mode: str, beam: int):
    """encode -> greedy (or beam, best beam kept) -> boxes by relevance.
    Returns (tokens (B, T-1), boxes (B, Q, 4), relevance (B, Q))."""
    from .decode.beam import beam_decode
    from .decode.greedy import greedy_decode
    memory, mem_valid, out = model.encode(images, query_ids, None,
                                          query_valid)
    cls_id = model.vocab_size - 3  # bench.py's VOCAB - 3
    if mode == "beam":
        seqs, _ = beam_decode(model, memory, mem_valid, cls_id, beam)
        tokens = seqs[:, 0]
    else:
        tokens, _, _ = greedy_decode(model, memory, mem_valid, cls_id)
    rel = out["pred_relevance_logits"].float().softmax(-1)[..., 0]
    order = torch.argsort(-rel, dim=-1, stable=True)
    boxes = torch.take_along_dim(out["pred_boxes"].float(), order[..., None],
                                 dim=1)
    return tokens, boxes, torch.take_along_dim(rel, order, 1)


def run(batch: int = BATCH, mode: str = "greedy", beam: int = 5,
        device=None, tiny: bool = False) -> dict:
    """Time the workload; returns the line's dict."""
    from .engine import resolve_device
    if mode not in ("greedy", "beam"):
        raise ValueError(f"mode={mode!r}: greedy or beam")
    dev = resolve_device(device)
    h, w = TINY["hw"] if tiny else (H, W)
    iters = TINY["iters"] if tiny else N_ITERS
    model = build_model(dev, tiny)
    g = torch.Generator(device=dev).manual_seed(0)
    images = torch.randn(batch, h, w, 3, device=dev, generator=g)
    query_ids = torch.randint(0, TINY["bert_vocab"] if tiny else BERT_VOCAB,
                              (batch, QUERY_TOKENS), device=dev, generator=g)
    query_valid = torch.ones(batch, QUERY_TOKENS, dtype=torch.bool,
                             device=dev)
    pinned = dev.type == "cuda"
    with torch.inference_mode():
        tokens, _, _ = infer(model, images, query_ids, query_valid, mode,
                             beam)
        tokens.cpu()  # warm-up done: cuDNN plans, allocator, the build
        # a distinct input buffer per timed iteration, as bench.py keeps
        image_rot = [images + (i + 1) * 1e-6 for i in range(iters)]
        slots = [torch.empty(tuple(tokens.shape), dtype=tokens.dtype,
                             pin_memory=pinned)
                 for _ in range(PIPELINE_DEPTH)]
        pending = [None] * PIPELINE_DEPTH  # the event of each slot's copy
        fetched = []
        if pinned:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for i in range(iters):
            tokens, _, _ = infer(model, image_rot[i], query_ids, query_valid,
                                 mode, beam)
            k = i % PIPELINE_DEPTH
            if pending[k] is not None:  # iteration i - 3: read it now
                pending[k].synchronize()
                fetched.append(slots[k].clone())
            slots[k].copy_(tokens, non_blocking=pinned)
            if pinned:
                pending[k] = torch.cuda.Event()
                pending[k].record()
            else:
                pending[k] = _Done()
        for j in range(iters, iters + PIPELINE_DEPTH):
            k = j % PIPELINE_DEPTH
            if pending[k] is not None:
                pending[k].synchronize()
                fetched.append(slots[k].clone())
        dt = time.perf_counter() - t0
    if len(fetched) != iters:
        raise RuntimeError(f"{len(fetched)} results fetched of {iters}")
    img_per_sec = batch * iters / dt
    name, limit = card_name_and_limit(dev)
    return {
        "metric": ("batched_inference_images_per_sec" if mode != "beam"
                   else f"batched_beam{beam}_inference_images_per_sec"),
        "value": round(img_per_sec, 2),
        "unit": "images/sec",
        # the greedy-eval denominator in beam mode too, as bench.py keeps it
        "vs_baseline": round(img_per_sec / PYTORCH_BASELINE_IMG_PER_SEC, 2),
        "baseline_estimated": True,
        "device": name,
        "power_limit_w": limit,
    }


class _Done:
    """The event of a copy that has already happened (the CPU)."""

    def synchronize(self) -> None:
        pass


def main(argv=None) -> None:
    args = dict(a.split("=", 1) for a in
                (sys.argv[1:] if argv is None else argv))
    unknown = set(args) - {"batch", "mode", "beam", "device", "dims"}
    if unknown:
        raise SystemExit(f"unknown arguments {sorted(unknown)}: batch=, "
                         "mode=greedy|beam, beam=, device=, dims=")
    dims = args.get("dims", "released")
    if dims not in ("released", "tiny"):
        raise SystemExit(f"dims={dims!r}: released or tiny")
    print(json.dumps(run(batch=int(args.get("batch", BATCH)),
                         mode=args.get("mode", "greedy"),
                         beam=int(args.get("beam", 5)),
                         device=args.get("device"), tiny=dims == "tiny")))


if __name__ == "__main__":
    main()
