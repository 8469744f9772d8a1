#!/usr/bin/env python3
"""Drive the PyTorch port (`gpv_tpu_torch`) on one CUDA card, end to end.

    python3 chip_smoke.py [--report PATH]

Run from the root of a checkout. Every engine is built through the
config entry point (`infer.build.build_engine` over
`configs/exp/gpv_inference.yaml`: ckpt=null, so seeded random weights at
the released widths, and a generated 10000-word answer vocabulary).
Phases, each printing one JSON line:
  device     the card, and its name and power limit as nvidia-smi gives
             them;
  build      nvcc builds every kernel source of gpv_tpu_torch/csrc
             (sm_90a), and g++ the native host runtime
             (gpv_tpu_torch/native) beside it;
  kernels    K1 (fused_attention) and K2 (fused_biattention) against their
             plain PyTorch versions at every shape of the paths below, fp32
             (TF32 off) and bf16, timed beside the plain version and SDPA:
             `ms` over 30 back-to-back calls (host cost included) and
             `device_ms`, one launch's device time from a CUDA-graph replay
             of 30 launches; `op_ms`, the same call through the torch op
             (`torch.ops.gpv.*`, what exported programs call);
  slice      GPVEngine.predict (B=20 uint8 480x640, 12-token queries, bf16,
             BN folded), with the kernels' launch counts read around one
             call;
  profile    torch.profiler over one more predict: device time by kernel,
             the port's kernels (prefix gpv_attn_) by variant, and the
             device's idle share;
  beam       GPVEngine.predict_beam, K=5 on the same batch, launch counts
             per kernel variant around one call, images/s;
  profile_beam  the same profile over one more predict_beam;
  e2e        the same weights in fp32 on the card (kernels) and on the CPU
             (plain versions), on 2 images: boxes, relevance, first-step
             logits, greedy tokens, and beam search with K=3 (sequences
             equal, log-probs);
  serve      GPVServer over the bf16 engine (buckets 1/8/20, 2 workers):
             1000 requests from 40 closed-loop clients mixing greedy, beam
             K=3 and the classification mask; every request resolved, the
             kernels' launches by variant against the batches the server
             ran, latency;
  vocab_embed  embed_vocab over the 10000 words with BERT-base in bf16
             (launch counts), and fp32 card against CPU on 64 words;
  eval       offline evaluation (`infer.predictions.predict_dataset` and
             `evaluate_predictions`) over seeded COCO-schema datasets of
             the five tasks, 110 samples each, pixels seeded at COCO's
             sizes and resized exactly on 8 forked loader processes: greedy
             for every task, beam K=5 for VQA and captioning. Per run:
             every sample predicted once, the evaluators' keys and finite
             metrics, launches by variant against the batches it made,
             one item's host ms, images/s of the loader alone (and its
             first batch's s) and of the pipeline, evaluator s, device
             idle share (profiled repeat); VQA 8 times over (880
             samples), loader and pipeline; threads against processes;
             every task again with the native resize (loader, pipeline,
             idle share); fp32 card against CPU on 8 VQA and 8 detection
             samples;
  export     the bf16 engine exported at buckets 1/8/20 (seconds per
             program, bytes: weights stored once), loaded by a fresh
             process with no model module imported, predicting the slice's
             batch and a batch of 5 padded to 8 (answers equal to the
             engine's, boxes and relevance 2e-2, launches by variant as
             path_launches gives them), images/s beside the engine's; fp32
             at B=4 against its engine (1e-4); GPVServer over the bundle
             (10 clients x 10 requests resolved, a beam request refused);
  train      `train.trainer.Trainer` over `configs/exp/gpv.yaml` at the
             released widths (learning_datasets all, bf16 autocast, fp32
             parameters and AdamW state, global batch 120 with the
             smallest grad_accum_steps of 1/2/4/8 that fits, query dedup,
             seeded COCO-schema data at COCO's sizes, exact resize on 8
             forked loader processes, seeded random weights): 2 warm-up
             and 5 timed steps through the loader, 3 on one resident
             batch, one step split by stage, the matcher's parts, one
             profiled step, peak memory, the in-train eval (40 samples a
             task), a save and a resume. Gates: every loss key finite,
             frozen parameters bit-unchanged and every other leaf moved,
             K1 12 launches a step at the dedup's rows, the eval's keys
             finite and its launches by variant, the restored state equal
             to the saved one, every shape a `kernels` case. Then the
             two-phase recipe (`two_phase`): phase 1 frozen from a seeded
             pretrained DETR, 2 steps, saved; phase 2 resumes it unfrozen:
             model and carried AdamW state equal to the saved ones, the
             unfrozen leaves start empty and move, step, epoch and the
             schedule's lr restored;
  train_native  phase 2 goes on with the native resize and the fused C++
             jitter (the numpy and exact paths refused, each batch's
             native calls counted): images/s through the loader and its
             wait beside `train`'s; the native matcher solve against
             scipy's loop on one step's 120 cost matrices (totals 1e-5);
  train_e2e  one train step in fp32 (TF32 off) on the card and on the CPU
             from the same weights at dropout 0, B=4, 480x640: losses
             within 1e-4 relative, the assignment equal, the clipped
             gradients within 1e-3 x max(1, max|g|) per leaf.
Then one `kernels` line (each kernel of the paths: launches and per-call
ms, device ms, bound in the measured predict, and the same for
predict_beam, embed_vocab, the whole serve run, the whole eval phase, one
train step, the in-train eval and the exported bundle's B=20 predict
under `paths`), and
last `{"ok": true,
"device": {...}}`. Any failed phase exits non-zero before that line;
without a CUDA device, or without the package beside this file, it exits
non-zero at once. `--report` also writes every phase's record to PATH as
JSON.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}  # dense tensor core
TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # x max(1, |plain| max)
B, IMG_H, IMG_W, QUERY_TOKENS, VOCAB = 20, 480, 640, 12, 10000
BEAM, E2E_BEAM = 5, 3
EMBED_BATCH = 256  # words a batch in embed_vocab
SERVE_BUCKETS, SERVE_BEAM = (1, 8, B), 3
SERVE_CLIENTS, SERVE_REQUESTS = 40, 25  # requests per client
# offline eval: task -> its node under task_configs
EVAL_TASKS = {"CocoVqa": "coco_vqa", "CocoCaptioning": "coco_captioning",
              "CocoDetection": "coco_detection",
              "CocoClassification": "coco_classification",
              "RefCocop": "refcocop"}
EVAL_BEAM_TASKS = ("CocoVqa", "CocoCaptioning")
EVAL_SAMPLES = 110   # 5 full batches of B and one of 10 (padded)
EVAL_WORKERS = 8     # eval.num_workers's default
EVAL_LOADER_TASK = "CocoVqa"  # also run with loader=threads
EVAL_HOST_ITEMS = 6  # items timed one by one in this process (3 images)
EVAL_STEADY_REPEATS = 8  # one task's samples 8 times over: 44 batches
EVAL_CHECK, EVAL_CHECK_TASKS = 8, ("CocoVqa", "CocoDetection")  # card vs CPU
EVAL_CLASSES = ("dog", "cat", "horse", "person")
COCO_SIZES = ((480, 640), (427, 640), (640, 480))  # (H, W)
NOVELTIES = ("everything", "seen_concepts", "held_out_concepts")
# training: learning_datasets all, the released global batch
TRAIN_TASKS = ("CocoCaptioning", "CocoDetection", "CocoClassification",
               "CocoVqa")
TRAIN_B, TRAIN_ACCUM = 120, (1, 2, 4, 8)  # batch, grad_accum_steps tried
TRAIN_SAMPLES, TRAIN_VAL = 240, 40  # a task: 8 batches of 120; val
TRAIN_WARMUP, TRAIN_STEPS, TRAIN_RESIDENT = 2, 5, 3
TRAIN_DEDUP_ROWS = 16   # U: 7 distinct queries padded to one bucket
E2E_TRAIN_B = 4
TRAIN_LOSS_KEYS = {"loss_caption", "loss_vqa", "loss_cls", "loss_ce",
                   "loss_bbox", "loss_giou", "cardinality_error",
                   "total_loss"}  # gpv_tpu's gpv_criterion keys
TRAIN_EVAL_KEYS = {"vqa_acc", "cider", "bleu4", "cls_acc", "det_map",
                   "model_selection_metric"}  # gpv_tpu's Trainer.evaluate
# frozen in every phase: BERT, the stem, the dead tokens, the vocab embed
FROZEN_PREFIXES = ("bert.", "detr.backbone.0.body.conv1.",
                   "detr.backbone.0.body.layer1.", "vision_token",
                   "lang_token", "answer_head.vocab_embed")
EVAL_METRIC_KEYS = {   # the keys of gpv_tpu's evaluators' metric dicts
    "CocoVqa": {"correct", "total", "absent", "accuracy"},
    "CocoClassification": {"correct", "overall_correct", "total",
                           "overall_total", "absent", "accuracy",
                           "overall_accuracy"},
    "CocoCaptioning": {"absent", "total", "scores"},
    "CocoDetection": {"absent", "total", "mAP"},
    "RefCocop": {"absent", "total", "mAP"}}


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """ms per call of `reps` back-to-back calls: host cost included."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 30):
    """(ms, method): one call's device time. The `reps` calls are captured
    in a CUDA graph after a warm-up outside capture, and a replay is timed
    with events, so the host's cost of each call drops out. Where capture
    refuses a call, torch.profiler's device time for `reps` calls is used
    instead."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
    except RuntimeError:
        return _profiled_device_ms(fn, reps), "profiler"
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(3):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return min(times), "cuda_graph"


def _device_events(prof):
    """(device ms, count, name) of each device-side kernel or copy."""
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        rows.append((dev_us / 1e3, e.count, e.key))
    return rows


def _profiled_device_ms(fn, reps: int) -> float:
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(r[0] for r in _device_events(prof)) / reps


# ---------------------------------------------------------------- phases

def phase_device() -> dict:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    rec = {"phase": "device", "nvidia_smi": smi,
           "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(),
           "capability": list(torch.cuda.get_device_capability(0)),
           "torch": torch.__version__, "cuda": torch.version.cuda}
    if tuple(rec["capability"]) < (9, 0):
        fail(f"the kernels target sm_90a; this card is sm_"
             f"{rec['capability'][0]}{rec['capability'][1]}")
    return rec


def _sass_mma(lib: Path) -> dict:
    """Tensor-core instructions (HMMA, and wgmma's HGMMA) per kernel in the
    built library, read with cuobjdump -sass; {} without cuobjdump."""
    from gpv_tpu_torch.ops import _cuda
    tool = Path(_cuda.nvcc()).with_name("cuobjdump")
    if not tool.is_file():
        return {}
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120).stdout
    counts, name = {}, None
    for ln in sass.splitlines():
        if "Function : " in ln:
            name = ln.split("Function : ", 1)[1].strip()
            counts[name] = 0
        elif name and ("HMMA" in ln or "HGMMA" in ln):
            counts[name] += 1
    return counts


def phase_build() -> dict:
    from concurrent.futures import ThreadPoolExecutor

    from gpv_tpu_torch.native import build as native_build
    from gpv_tpu_torch.ops import _cuda

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    with ThreadPoolExecutor(1) as pool:  # g++ beside the nvcc runs
        native = pool.submit(timed, native_build.build_native)
        seconds = _cuda.build_all()
        native_s = native.result()
    ptxas = [ln.strip() for name in _cuda.SOURCES
             for ln in _cuda.build_log(name).splitlines()
             if "Used" in ln or "spill" in ln]
    mma = {name: _sass_mma(_cuda._target(name)) for name in _cuda.SOURCES}
    tile = mma["attention_tile"]
    if tile and not all(tile.values()):
        fail(f"a tile kernel issues no tensor-core instruction: {tile}")
    return {"phase": "build", "sources": list(_cuda.SOURCES),
            "seconds": seconds, "ptxas": ptxas, "sass_mma_per_kernel": mma,
            "native_sources": list(native_build.SOURCES),
            "native_seconds": native_s,
            "native_library": native_build.library_path().name}


class Case(NamedTuple):
    """One attention shape of a path. K1: Tq query rows against Tk keys
    with key validity `mask` (a kind of `_valid`). K2 (name `masks_*`):
    the vision stream's Tq=100 rows against the text stream's Tk=20."""
    name: str
    b: int
    tq: int
    tk: int
    h: int
    dh: int
    mask: Optional[str]
    causal: bool = False

    @property
    def k2(self) -> bool:
        return self.name.startswith("masks_")

    @property
    def variant(self) -> str:
        """The kernel a bf16 call takes: K2 and Tq >= 2 the tile kernel,
        Tq = 1 the decode kernel."""
        return "tile" if self.k2 or self.tq > 1 else "decode"


def path_launches(path: str, steps: int, batch: int = B, beam: int = BEAM,
                  words: int = VOCAB) -> Counter:
    """{Case: launches} in one call of `path` on `batch` samples:
    "predict" (greedy, `steps` decode steps), "predict_beam" (`beam`
    beams, `steps` steps) or "embed_vocab" (`words` words in batches of
    EMBED_BATCH). The gates, the profiles and the kernels line all count
    from here."""
    if path == "embed_vocab":
        full, tail = divmod(words, EMBED_BATCH)
        out = Counter({Case("vocab_embed_bert", EMBED_BATCH, 16, 16, 12, 64,
                            "random"): 12 * full})
        if tail:
            out[Case(f"vocab_embed_bert_b{tail}", tail, 16, 16, 12, 64,
                     "random")] = 12
        return out
    s = "" if batch == B else f"_b{batch}"
    out = Counter({
        Case("detr_encoder_self" + s, batch, 300, 300, 8, 32, None): 6,
        Case("detr_decoder_self" + s, batch, 100, 100, 8, 32, None): 6,
        Case("detr_decoder_cross" + s, batch, 100, 300, 8, 32, None): 6,
        Case("bert_self" + s, batch, 20, 20, 12, 64, "query"): 12,
        # K2: query-masked text, unmasked vision
        Case("masks_10" + s, batch, 100, 20, 16, 48, "query"): 3})
    if path == "predict":
        step, rows, tq = "decode_step", batch, 1
    else:  # B·K beam rows on the cache; a sample's K beams as K query rows
        step = "beam_step" if beam == BEAM else f"beam{beam}_step"
        rows, tq = batch * beam, beam
    out[Case(f"{step}_self{s}", rows, 1, 20, 8, 96, "cache")] = 3 * steps
    out[Case(f"{step}_cross{s}", batch, tq, 120, 8, 96, "memory")] = \
        3 * steps
    return out


def path_cases() -> list:
    """Every shape of every call this script makes, once each: predict
    and predict_beam at B, embed_vocab, and both paths at each serving
    bucket; then the teacher-forced causal shape (training's, on no path
    here)."""
    calls = [path_launches("predict", 0), path_launches("predict_beam", 0),
             path_launches("embed_vocab", 0)]
    for b in SERVE_BUCKETS:
        calls += [path_launches("predict", 0, b),
                  path_launches("predict_beam", 0, b, SERVE_BEAM)]
    calls += [train_step_launches(TRAIN_DEDUP_ROWS, True),
              train_step_launches(TRAIN_B, False),
              train_step_launches(E2E_TRAIN_B, False)]
    return list(dict.fromkeys(c for counts in calls for c in counts)) + [
        Case("teacher_forced_causal", B, 20, 20, 8, 96, None, True)]


def train_step_launches(rows: int, dedup: bool) -> Counter:
    """{Case: launches} of one train step: frozen BERT on K1 alone (12
    layers) at `rows` query rows (the dedup's U unique rows, or the whole
    batch); DETR, co-attention and the text decoder take the training
    attention and launch nothing."""
    name = (f"bert_self_train_u{rows}" if dedup
            else "bert_self_train" + ("" if rows == TRAIN_B else f"_b{rows}"))
    return Counter({Case(name, rows, 20, 20, 12, 64, "query"): 12})


def k1_cases() -> list:
    return [c for c in path_cases() if not c.k2]


def by_variant(counts: Counter) -> dict:
    """{Case: launches} -> launches by wrapper and kernel variant, in the
    form the wrappers count them (bf16 calls: fp32 never)."""
    out = {"fused_attention": {"tile": 0, "decode": 0, "fp32": 0},
           "fused_biattention": {"tile": 0, "fp32": 0}}
    for c, n in counts.items():
        out["fused_biattention" if c.k2 else "fused_attention"][c.variant] \
            += n
    return out


def _valid(kind, b, Tk, device, g):
    """(b, Tk) key validity of the main path's kind, or random (at least
    the first key valid) for any other kind."""
    import torch
    if kind is None:
        return None
    if kind == "query":   # 12 real tokens of the padded 20
        return (torch.arange(Tk, device=device) < QUERY_TOKENS).expand(
            b, Tk).contiguous()
    if kind == "cache":   # decode position t = 9 of the 20-slot cache
        return (torch.arange(Tk, device=device) <= 9).expand(
            b, Tk).contiguous()
    if kind == "memory":  # 100 vision slots + 12 of 20 query slots
        idx = torch.arange(Tk, device=device)
        return (idx < 100 + QUERY_TOKENS).expand(b, Tk).contiguous()
    v = torch.rand(b, Tk, device=device, generator=g) > 0.3
    v[:, 0] = True
    return v


def _bound(bytes_moved: float, flops: float, dtype: str) -> dict:
    """The least time for the work: each input read once, each output
    written once, at the card's memory rate; the multiply-adds at the
    tensor-core peak for the input type. The larger one bounds."""
    t_bytes = 1e3 * bytes_moved / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / PEAK_FLOPS[dtype]
    return {"bytes": bytes_moved, "flops": flops, "bytes_ms": t_bytes,
            "ops_ms": t_ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _timings(calls: dict) -> dict:
    """`<prefix>ms` (host-inclusive) and `<prefix>device_ms` of each call,
    and how the device times were taken."""
    out, methods = {}, set()
    for prefix, fn in calls.items():
        out[f"{prefix}ms"] = time_ms(fn)
        out[f"{prefix}device_ms"], method = device_ms(fn)
        methods.add(method)
    out["device_ms_method"] = "+".join(sorted(methods))
    return out


def _k2_runs():
    """(K2 case, text masked, vision masked) for each K2 run."""
    for c in path_cases():
        if c.k2:
            combos = (((True, False), (False, False), (True, True),
                       (False, True)) if c.b == B else ((True, False),))
            for has1, has2 in combos:
                yield c, has1, has2


def phase_kernels() -> dict:
    import torch
    import torch.nn.functional as F
    from gpv_tpu_torch.ops import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    k1, k2 = [], []
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            for c in k1_cases():
                name, b, tq, tk, h, dh, mk, causal = c
                q, k, v = (torch.randn(b, t, h, dh, device=dev, generator=g)
                           .to(dtype) for t in (tq, tk, tk))
                kv = _valid(mk, b, tk, dev, g)
                got = A.fused_attention(q, k, v, kv, causal)
                ref = A.attend_plain(q, k, v, kv, causal)
                torch.cuda.synchronize()
                err = (got.float() - ref.float()).abs().max().item()
                scale = max(1.0, ref.float().abs().max().item())
                if not err <= TOL[dname] * scale:
                    fail(f"K1 {name} {dname}: max abs err {err} > "
                         f"{TOL[dname]} x {scale}")
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                sdpa_mask = None if kv is None else kv[:, None, None, :]
                calls = {
                    "": lambda: A.fused_attention(q, k, v, kv, causal),
                    "plain_": lambda: A.attend_plain(q, k, v, kv, causal),
                    "library_": lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=sdpa_mask, is_causal=causal)}
                rec = {"case": name, "dtype": dname,
                       "shape": [b, tq, tk, h, dh],
                       "variant": A._plan(dtype, tq, tk, dh).variant,
                       "max_abs_err": err, "tol": TOL[dname] * scale,
                       **_timings(calls),
                       "op_ms": time_ms(lambda: torch.ops.gpv.fused_attention(
                           q, k, v, kv, causal))}
                nbytes = (2 * q.numel() + k.numel() + v.numel()) \
                    * q.element_size() + (0 if kv is None else kv.numel())
                rec.update(_bound(nbytes, 4.0 * b * h * tq * tk * dh, dname))
                k1.append(rec)
            # K2: text T1=20 (12 valid) x vision T2=100, 16 heads, Dh 48;
            # at B every mask combination, at a serving bucket the path's
            for c, has1, has2 in _k2_runs():
                b, t2, t1, h, dh = c.b, c.tq, c.tk, c.h, c.dh
                xs = [torch.randn(b, t, h, dh, device=dev,
                                  generator=g).to(dtype)
                      for t in (t1, t1, t1, t2, t2, t2)]
                v1 = _valid("query", b, t1, dev, g) if has1 else None
                v2 = _valid("random", b, t2, dev, g) if has2 else None
                got = A.fused_biattention(*xs, v1, v2)
                ref = A.biattend_plain(*xs, v1, v2)
                torch.cuda.synchronize()
                err, tol = 0.0, 0.0
                for a, r in zip(got, ref):
                    scale = max(1.0, r.float().abs().max().item())
                    e = (a.float() - r.float()).abs().max().item()
                    if not e <= TOL[dname] * scale:
                        fail(f"K2 masks=({has1},{has2}) {dname}: max abs "
                             f"err {e} > {TOL[dname]} x {scale}")
                    err, tol = max(err, e), max(tol, TOL[dname] * scale)
                tr = [x.transpose(1, 2) for x in xs]
                m1 = None if v1 is None else v1[:, None, None, :]
                m2 = None if v2 is None else v2[:, None, None, :]

                def sdpa_pair():
                    F.scaled_dot_product_attention(tr[3], tr[1], tr[2],
                                                   attn_mask=m1)
                    F.scaled_dot_product_attention(tr[0], tr[4], tr[5],
                                                   attn_mask=m2)
                calls = {
                    "": lambda: A.fused_biattention(*xs, v1, v2),
                    "plain_": lambda: A.biattend_plain(*xs, v1, v2),
                    "sdpa_two_calls_": sdpa_pair}
                rec = {"case": f"masks_{int(has1)}{int(has2)}"
                       + c.name[len("masks_10"):], "dtype": dname,
                       "shape": [b, t2, t1, h, dh],
                       "variant": A._plan(dtype, t2, t1, dh,
                                          both=True).variant,
                       "max_abs_err": err, "tol": tol, "library_ms": None,
                       "library_device_ms": None, **_timings(calls),
                       "op_ms": time_ms(lambda: torch.ops.gpv
                                        .fused_biattention(*xs, v1, v2))}
                # six inputs read once; ctx1, ctx2 written (shapes of q2, q1)
                nbytes = (sum(x.numel() for x in xs) + xs[0].numel()
                          + xs[3].numel()) * xs[0].element_size() \
                    + sum(0 if m is None else m.numel() for m in (v1, v2))
                rec.update(_bound(nbytes, 2 * 4.0 * b * h * t1 * t2 * dh,
                                  dname))
                k2.append(rec)
    return {"phase": "kernels", "K1": k1, "K2": k2}


def _queries(n: int, rng):
    """Queries of exactly QUERY_TOKENS WordPiece tokens under the debug
    tokenizer (one piece per letter, plus [CLS] and [SEP])."""
    letters = "abcdefghijklmnopqrstuvwxyz"
    out = []
    for _ in range(n):
        word = "".join(rng.choice(list(letters), QUERY_TOKENS - 6))
        out.append(f"what {word}")
    return out


# the port's kernels by the name each __global__ function has in a trace,
# most specific first: (variant key, name fragment)
PORT_KERNELS = (("K2 tile", "gpv_attn_tile_bi_kernel"),
                ("K1 tile", "gpv_attn_tile_kernel"),
                ("K1 decode", "gpv_attn_decode_kernel"),
                ("fp32", "gpv_attn_fp32"))


def phase_profile(phase: str, call, counts: Counter) -> dict:
    """torch.profiler over one `call()` (a predict or predict_beam): device
    time by kernel, the port's kernels by variant, and the share of the
    call's wall time in which the card ran no kernel. Fails unless the
    wrappers' counters, read around the profiled call, show each port
    kernel launched as often as `counts` ({Case: launches}, or a function
    giving them once the call has run) says, and unless the trace shows
    them too. A trace of a train step has lacked one K1 record, the same
    one in every attempt, while the counters held (PERF.md §7): with fixed
    `counts` the call is profiled once more, and a trace still short of
    launches the counters saw is recorded (`trace_launches_short`) rather
    than failed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for attempt in (1, 2):
        _reset_counts()
        with profile(activities=acts) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        wrappers = _read_counts()[1]
        want = counts() if callable(counts) else counts
        _check_counts(phase, wrappers, want)
        rec = _profile_record(phase, prof, wall_ms, want)
        rec["attempts"] = attempt
        if rec.pop("launches_match") or callable(counts):
            break
    short = {k: n - rec["profiled_launches"][k]
             for k, n in rec["expected_launches"].items()
             if n != rec["profiled_launches"][k]}
    if any(n < 0 for n in short.values()) or (short and callable(counts)):
        fail(f"{phase}: profiled kernel launches {rec['profiled_launches']}"
             f" != expected {rec['expected_launches']}")
    if short:
        rec["trace_launches_short"] = short
        print(f"chip_smoke: {phase}: the trace lacks {short} launches the "
              "counters saw", file=sys.stderr, flush=True)
    return rec


def _profile_record(phase: str, prof, wall_ms: float, counts) -> dict:
    rows = sorted(_device_events(prof), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    groups = (("port_attention_kernels", ("gpv_attn_",)),
              ("conv", ("conv", "cudnn", "fprop", "implicit")),
              ("gemm", ("gemm", "nvjet", "cutlass", "xmma")),
              ("memcpy", ("memcpy",)))
    by_group = {g: 0.0 for g, _ in groups}
    by_group["other"] = 0.0
    port = {key: {"launches": 0, "device_ms": 0.0} for key, _ in PORT_KERNELS}
    for ms, n, name in rows:
        low = name.lower()
        group = next((g for g, words in groups
                      if any(w in low for w in words)), "other")
        by_group[group] += ms
        key = next((k for k, frag in PORT_KERNELS if frag in name), None)
        if key is not None:
            port[key]["launches"] += n
            port[key]["device_ms"] += ms
    got = {k: v["launches"] for k, v in port.items()}
    v = by_variant(counts)
    want = {"K2 tile": v["fused_biattention"]["tile"],
            "K1 tile": v["fused_attention"]["tile"],
            "K1 decode": v["fused_attention"]["decode"], "fp32": 0}
    return {"phase": phase, "launches_match": got == want,
            "profiled_launches": got, "expected_launches": want,
            "port_kernel_names": {name[:120]: n for _, n, name in rows
                                  if "gpv_attn" in name},
            "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "ms_by_group": by_group, "port_kernels": port,
            "top_kernels": [{"ms": ms, "count": n, "name": name[:90]}
                            for ms, n, name in rows[:15]]}


def _reset_counts():
    from gpv_tpu_torch.ops.attention import fused_attention, fused_biattention
    for w in (fused_attention, fused_biattention):
        w.launches = 0
        w.variant_launches = dict.fromkeys(w.variant_launches, 0)


def _read_counts():
    """({wrapper: launches}, {wrapper: {variant: launches}})."""
    from gpv_tpu_torch.ops.attention import fused_attention, fused_biattention
    wrappers = (fused_attention, fused_biattention)
    return ({w.__name__: w.launches for w in wrappers},
            {w.__name__: dict(w.variant_launches) for w in wrappers})


def _check_counts(phase: str, got: dict, counts: Counter) -> None:
    """Fails unless the wrappers' counts by variant (`_read_counts`) are
    what `counts` ({Case: launches}) gives."""
    want = by_variant(counts)
    if got != want:
        fail(f"{phase}: launches by variant {got} != expected {want}")


def write_vocab(directory: Path) -> Path:
    """A generated VOCAB-word answer vocabulary (`vocab.json`)."""
    from gpv_tpu_torch.text.vocab import AnswerVocab
    path = directory / "vocab.json"
    path.write_text(json.dumps(AnswerVocab.debug(size=VOCAB).words))
    return path


def make_engine(vocab_path: Path, dtype: str, device: str):
    """The engine of `configs/exp/gpv_inference.yaml` at the released
    widths, seeded random weights (ckpt=null), through the entry point."""
    from gpv_tpu_torch.infer.build import build_engine
    from gpv_tpu_torch.utils.config import load_config
    return build_engine(load_config(
        ROOT / "configs", "exp/gpv_inference",
        ["ckpt=null", f"tpu.dtype={dtype}", f"model.vocab={vocab_path}",
         f"device={device}"]))


def _check_boxes(rows) -> None:
    for r in rows:
        boxes, rel = r["boxes"], r["relevance"]
        if boxes.shape != (100, 4) or rel.shape != (100,):
            fail(f"shapes boxes {boxes.shape} relevance {rel.shape}")
        if not (np.isfinite(boxes).all() and (boxes >= 0).all()
                and (boxes <= 1).all()):
            fail("boxes not finite in [0, 1]")
        if not (np.isfinite(rel).all() and (np.diff(rel) <= 0).all()):
            fail("relevance not finite and sorted descending")


def _batch(seed: int, n: int):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (n, IMG_H, IMG_W, 3)).astype(np.uint8),
            _queries(n, rng))


def _images_per_s(fn, n_iter: int) -> float:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_iter):
        fn()
    torch.cuda.synchronize()
    return B * n_iter / (time.perf_counter() - t0)


def phase_slice(eng, setup_s: float):
    import torch

    images, queries = _batch(0, B)
    _, qvalid = eng.tokenizer.batch_encode(queries, eng.max_query_len)
    if qvalid.shape != (B, 20) or not (qvalid.sum(1) == QUERY_TOKENS).all():
        fail(f"queries are not {QUERY_TOKENS} tokens: {qvalid.sum(1)}")
    eng.predict(images, queries)          # warm-up (cuDNN plans, allocator)
    torch.cuda.synchronize()

    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = eng.predict(images, queries)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    launches, by_variant = _read_counts()
    steps = eng.last_decode_steps
    counts = path_launches("predict", steps)
    _check_counts("slice", by_variant, counts)
    if len(results) != B:
        fail(f"{len(results)} results for {B} images")
    _check_boxes(results)
    if not all(isinstance(r["answer"], str) for r in results):
        fail("answer is not a string")
    rec = {"phase": "slice", "batch": B, "image_hw": [IMG_H, IMG_W],
           "dtype": "bfloat16", "decode_steps": steps,
           "launches": launches, "launches_by_variant": by_variant,
           "engine_setup_s": setup_s,
           "measured_call_s": call_s,
           "images_per_s": _images_per_s(
               lambda: eng.predict(images, queries), 5),
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "answers": [r["answer"] for r in results[:3]]}
    return rec, counts, phase_profile(
        "profile", lambda: eng.predict(images, queries), counts)


def phase_beam(eng):
    """predict_beam, K=BEAM, on the slice's batch: per step the cache
    attention runs on the decode kernel at B·K rows, the cross-attention
    on the tile kernel with the K beams as query rows. Returns its record
    and a profile of one more call."""
    import torch

    images, queries = _batch(0, B)
    eng.predict_beam(images, queries, beam_size=BEAM)   # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = eng.predict_beam(images, queries, beam_size=BEAM)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    launches, by_variant = _read_counts()
    steps = eng.last_decode_steps
    counts = path_launches("predict_beam", steps)
    _check_counts("beam", by_variant, counts)
    if len(results) != B:
        fail(f"beam: {len(results)} results for {B} images")
    _check_boxes(results)
    for r in results:
        p = np.asarray(r["answer_probs"])
        if len(r["answers"]) != BEAM or p.shape != (BEAM,):
            fail(f"beam: {len(r['answers'])} answers, probs {p.shape}")
        # exp of fp32 log-probs, as gpv_tpu takes it: a random model's
        # 19-step log-prob can lie below fp32's range and give 0
        if not (np.isfinite(p).all() and (p >= 0).all() and (p <= 1).all()
                and (np.diff(p) <= 0).all()):
            fail(f"beam: answer_probs not finite, in [0, 1], "
                 f"non-increasing: {p}")
    rec = {"phase": "beam", "batch": B, "beam_size": BEAM,
           "dtype": "bfloat16", "decode_steps": steps,
           "launches": launches, "launches_by_variant": by_variant,
           "measured_call_s": call_s,
           "images_per_s": _images_per_s(
               lambda: eng.predict_beam(images, queries, beam_size=BEAM), 3),
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "answers": results[0]["answers"],
           "answer_probs": results[0]["answer_probs"]}
    return rec, counts, phase_profile(
        "profile_beam",
        lambda: eng.predict_beam(images, queries, beam_size=BEAM), counts)


def phase_e2e(vocab_path: Path) -> dict:
    import torch
    from gpv_tpu_torch.decode.beam import beam_decode
    from gpv_tpu_torch.decode.greedy import greedy_decode
    from gpv_tpu_torch.ops.image import normalize_image

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(1)
    images = rng.randint(0, 256, (2, IMG_H, IMG_W, 3)).astype(np.uint8)
    queries = _queries(2, rng)
    outs = {}
    for device in ("cuda", "cpu"):
        eng = make_engine(vocab_path, "float32", device)
        dev = eng.device
        ids, valid = eng.tokenizer.batch_encode(queries, 20)
        with torch.inference_mode():
            x = normalize_image(torch.from_numpy(images).to(dev).float()
                                / 255.0)
            memory, mem_valid, out = eng.model.encode(
                x, torch.from_numpy(ids).long().to(dev), None,
                torch.from_numpy(valid).to(dev))
            tokens, logits, _ = greedy_decode(
                eng.model, memory, mem_valid, eng.vocab.cls_id)
            seqs, logp = beam_decode(eng.model, memory, mem_valid,
                                     eng.vocab.cls_id, E2E_BEAM)
        outs[device] = {
            "boxes": out["pred_boxes"].float().cpu(),
            "relevance": out["pred_relevance_logits"].float().softmax(-1)
            [..., 0].cpu(),
            "logits0": logits[:, 0].cpu(), "tokens": tokens.cpu(),
            "beam_log_prob": logp.cpu(), "beam_seqs": seqs.cpu()}
        del eng
    c, p = outs["cuda"], outs["cpu"]
    rec = {"phase": "e2e", "images": 2, "dtype": "float32",
           "beam_size": E2E_BEAM}
    for key, tol in (("boxes", 1e-3), ("relevance", 1e-3),
                     ("logits0", 2e-3), ("beam_log_prob", 2e-3)):
        err = (c[key] - p[key]).abs().max().item()
        rec[f"{key}_max_abs_err"], rec[f"{key}_tol"] = err, tol
        if not err <= tol:
            fail(f"e2e {key}: max abs err {err} > {tol}")
    rec["greedy_token_agreement"] = (c["tokens"] == p["tokens"]).float() \
        .mean().item()
    if not torch.equal(c["beam_seqs"], p["beam_seqs"]):
        fail(f"e2e beam sequences differ, card {c['beam_seqs'].tolist()} "
             f"cpu {p['beam_seqs'].tolist()}")
    rec["beam_seqs_equal"] = True
    return rec


class _Recorder:
    """The engine as GPVServer sees it, logging each call the server
    makes: (path, rows, beams, decode steps)."""

    def __init__(self, eng):
        self.eng, self.vocab, self.calls = eng, eng.vocab, []
        self._lock = threading.Lock()

    def load_weights(self, model):
        self.eng.load_weights(model)

    def _log(self, path, rows, beam):
        with self._lock:
            self.calls.append((path, rows, beam, self.eng.last_decode_steps))

    def predict(self, images, queries, vocab_mask=None):
        out = self.eng.predict(images, queries, vocab_mask)
        self._log("predict", len(queries), None)
        return out

    def predict_beam(self, images, queries, beam_size=5, vocab_mask=None,
                     reference_quirks=False):
        out = self.eng.predict_beam(images, queries, beam_size=beam_size,
                                    vocab_mask=vocab_mask,
                                    reference_quirks=reference_quirks)
        self._log("predict_beam", len(queries), beam_size)
        return out

    def launches(self) -> Counter:
        """{Case: launches} of the calls logged so far."""
        run = Counter()
        for path, rows, beam, steps in self.calls:
            run.update(path_launches(path, steps, rows, beam or BEAM))
        return run


def phase_serve(eng, checked: set):
    """GPVServer over the bf16 engine: SERVE_CLIENTS closed-loop clients of
    SERVE_REQUESTS requests each (one after another), mixing greedy, beam
    K=SERVE_BEAM and the COCO classification mask; enough clients that a
    batch key can fill the largest bucket. Every request must resolve and
    none may fail; from the warm-up's end to close(drain=True) the kernels
    must launch as the batches the server ran say, each at a shape the
    kernels phase held against its plain version (`checked`: case names).
    Returns the record and the run's {Case: launches}."""
    from gpv_tpu_torch.evaluation.vocab_mask import coco_vocab_mask
    from gpv_tpu_torch.serve import GPVServer

    mask = coco_vocab_mask(eng.vocab)
    images, queries = _batch(2, 16)
    recorder = _Recorder(eng)
    t0 = time.perf_counter()
    server = GPVServer(recorder, bucket_sizes=SERVE_BUCKETS, max_wait_ms=5,
                       num_workers=2, warmup=(IMG_H, IMG_W))
    warmup_s = time.perf_counter() - t0
    recorder.calls.clear()
    _reset_counts()
    kinds = ("greedy", "beam", "classification")
    errors, counts = [], dict.fromkeys(kinds, 0)
    lock = threading.Lock()

    def client(c: int) -> None:
        for r in range(SERVE_REQUESTS):
            i = (SERVE_REQUESTS * c + r) % len(queries)
            kind = kinds[(c + r) % 3]
            fut = server.submit(
                images[i], queries[i],
                mask if kind == "classification" else None,
                beam_size=SERVE_BEAM if kind == "beam" else None)
            out = fut.result(timeout=300)
            ok = (len(out.get("answers", [out["answer"]]))
                  == (SERVE_BEAM if kind == "beam" else 1)
                  and out["boxes"].shape == (100, 4))
            with lock:
                counts[kind] += 1
                if not ok:
                    errors.append((c, r, kind))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(SERVE_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall_s = time.perf_counter() - t0
    server.close(drain=True)
    launches, by_var = _read_counts()
    stats = server.stats()
    n = SERVE_CLIENTS * SERVE_REQUESTS
    if any(t.is_alive() for t in threads):
        fail("serve: a client did not finish")
    if errors:
        fail(f"serve: malformed results {errors}")
    if not (stats["completed"] == stats["submitted"] == n
            and stats["failed"] == 0):
        fail(f"serve: {stats}")
    ran = Counter(rows for _, rows, _, _ in recorder.calls)
    if ran != Counter({b: k for b, k in stats["batches_per_bucket"].items()
                       if k}):
        fail(f"serve: engine calls by rows {dict(ran)} != the server's "
             f"batches {stats['batches_per_bucket']}")
    run = recorder.launches()
    unchecked = {c.name for c in run} - checked
    if unchecked:
        fail(f"serve: shapes not held against their plain version in the "
             f"kernels phase: {sorted(unchecked)}")
    _check_counts("serve", by_var, run)
    batches = Counter(f"{p}{'' if k is None else f' K={k}'} x{rows}"
                      for p, rows, k, _ in recorder.calls)
    return {"phase": "serve", "requests": counts, "clients": SERVE_CLIENTS,
            "warmup_s": warmup_s, "wall_s": wall_s,
            "requests_per_s": n / wall_s, "launches": launches,
            "launches_by_variant": by_var,
            "batches_by_call": dict(sorted(batches.items())),
            "decode_steps": sorted({s for *_, s in recorder.calls}),
            **stats}, run


def phase_vocab_embed(vocab_path: Path) -> dict:
    """embed_vocab over the generated vocabulary with BERT-base: bf16 on
    the card with the launch counts read around it (12 tile launches a
    batch), then fp32 card against CPU on the first 64 words."""
    import torch
    from gpv_tpu_torch.data.vocab_embed import embed_vocab
    from gpv_tpu_torch.nn.bert import BertEncoder
    from gpv_tpu_torch.text.wordpiece import WordPieceTokenizer
    from gpv_tpu_torch.weights import init_random

    words = json.loads(vocab_path.read_text())
    tok = WordPieceTokenizer.debug()
    bert = init_random(BertEncoder(), seed=0)
    embed_vocab(words[:EMBED_BATCH], tok, bert, device="cuda",
                dtype=torch.bfloat16)  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    emb = embed_vocab(words, tok, bert, batch_size=EMBED_BATCH,
                      device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    launches, by_variant = _read_counts()
    batches = -(-len(words) // EMBED_BATCH)
    counts = path_launches("embed_vocab", 0, words=len(words))
    _check_counts("vocab_embed", by_variant, counts)
    if emb.shape != (len(words), 768) or not np.isfinite(emb).all():
        fail(f"vocab_embed: shape {emb.shape} or non-finite values")
    got = embed_vocab(words[:64], tok, bert, device="cuda")
    want = embed_vocab(words[:64], tok, bert, device="cpu")
    err = float(np.abs(got - want).max())
    if not err <= 1e-3:
        fail(f"vocab_embed: fp32 card against CPU max abs err {err} > 1e-3")
    return {"phase": "vocab_embed", "words": len(words), "batches": batches,
            "dtype": "bfloat16", "launches": launches,
            "launches_by_variant": by_variant, "measured_call_s": call_s,
            "words_per_s": len(words) / call_s,
            "fp32_cuda_vs_cpu_max_abs_err": err, "tol": 1e-3}, counts


def eval_samples(task: str, n: int = EVAL_SAMPLES) -> list:
    """`n` seeded samples of `task` in COCO's sample schema (as
    `tests/_fake_data.py` writes them): an id, a query, answers or boxes,
    the image (two samples an image; W and H for the box tasks, from the
    image's COCO size), and coco_categories, every third sample with an
    unseen class so that each novelty split has samples."""
    from gpv_tpu_torch.evaluation.evaluators import TASK_TO_ID_FIELD
    rng = np.random.RandomState(sorted(EVAL_TASKS).index(task))
    words = ("a", "man", "dog", "cat", "horse", "riding", "red", "on", "the")
    out = []
    for i in range(n):
        image_id = 1000 + i // 2
        h, w = COCO_SIZES[image_id % len(COCO_SIZES)]
        cls = EVAL_CLASSES[i % len(EVAL_CLASSES)]
        s = {TASK_TO_ID_FIELD[task]: 1 + i,
             "image": {"subset": "val2014", "image_id": image_id},
             "coco_categories": {"seen": [cls],
                                 "unseen": ["cat"] if i % 3 == 0 else []}}
        x, y = rng.uniform(0, 0.6 * w), rng.uniform(0, 0.6 * h)
        box = [x, y, rng.uniform(8, w - x), rng.uniform(8, h - y)]
        if task == "CocoVqa":
            a, b = rng.choice(("two", "yes", "no", "red", "dog"), 2,
                              replace=False)
            s.update(query="what is on the table?", answer=str(a),
                     all_answers={str(a): 7, str(b): 3},
                     anno={"answer_type": ("number", "yes/no")[i % 2],
                           "question_type": ("how many", "is the")[i % 3 > 0]})
        elif task == "CocoCaptioning":
            s.update(query="describe the image",
                     answer=" ".join(rng.choice(words, 6)))
        elif task == "CocoClassification":
            s.update(query="what is this?", boxes=box, answer=cls,
                     category_id=1 + i % len(EVAL_CLASSES))
        else:
            s["image"].update(W=w, H=h)
            if task == "CocoDetection":
                s.update(query=f"locate the {cls}", category_name=cls,
                         boxes=[box, [0.5 * w, 0.5 * h, 0.3 * w, 0.2 * h]])
            else:
                s.update(query=f"the {cls} on the left", boxes=[box])
        out.append(s)
    return out


class _SeededPixels:
    """A task dataset whose pixels are seeded uint8 at the image's COCO
    size, made from the image id: no JPEG files and no PIL. Crop, resize,
    box normalisation and transforms are the dataset's own."""

    def load_pixels(self, sample):
        image_id = int(sample["image"]["image_id"])
        h, w = COCO_SIZES[image_id % len(COCO_SIZES)]
        return np.random.RandomState(image_id).randint(
            0, 256, (h, w, 3), dtype=np.uint8)


def eval_datasets(data_dir: Path, resize: str = "exact") -> dict:
    """{task: dataset} over seeded samples written under `data_dir`, read
    through `configs/exp/gpv.yaml`'s task configs at 480x640 with
    `host_resize: <resize>` (exact: the reference's eval pixels)."""
    from gpv_tpu_torch.datasets.coco import DATASET_CLASSES
    from gpv_tpu_torch.utils.config import load_config
    cfg = load_config(ROOT / "configs", "exp/gpv",
                      [f"data_dir={data_dir}",
                       f"task_configs.host_resize={resize}"])
    out = {}
    for task, node in EVAL_TASKS.items():
        task_cfg = cfg.task_configs[node]
        path = Path(task_cfg.samples.val)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(eval_samples(task)))
        cls = DATASET_CLASSES[task]
        out[task] = type(cls.__name__, (_SeededPixels, cls), {})(task_cfg,
                                                                 "val")
    return out


def _finite_leaves(obj) -> bool:
    if isinstance(obj, dict):
        return all(_finite_leaves(v) for v in obj.values())
    return bool(np.isfinite(obj))


def _check_metrics(task: str, metrics: dict) -> None:
    """The JAX evaluators' keys, finite values, every novelty split
    non-empty and no sample absent."""
    if set(metrics) != set(NOVELTIES):
        fail(f"eval {task}: novelties {sorted(metrics)}")
    for novelty, m in metrics.items():
        if set(m) != EVAL_METRIC_KEYS[task] or not _finite_leaves(m):
            fail(f"eval {task} {novelty}: keys {sorted(m)} or a value not "
                 f"finite: {m}")
        total = m["total"]
        total = total.get("all", 0) if isinstance(total, dict) else total
        total = m.get("overall_total", total)
        if m["absent"] != 0 or not total > 0:
            fail(f"eval {task} {novelty}: absent {m['absent']}, total "
                 f"{total}")


def _eval_card_vs_cpu(vocab_path: Path, datasets: dict, tmp: Path) -> dict:
    """The first EVAL_CHECK samples of VQA and detection through an fp32
    engine on the card and one on the CPU: equal answers, boxes and
    relevance within 1e-3, equal metrics."""
    import torch
    from gpv_tpu_torch.infer.predictions import (evaluate_predictions,
                                                 predict_dataset)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    outs = {}
    for device in ("cuda", "cpu"):
        eng = make_engine(vocab_path, "float32", device)
        for task in EVAL_CHECK_TASKS:
            ds = datasets[task]
            preds, boxes = predict_dataset(eng, ds, task, EVAL_CHECK,
                                           num_eval_batches=1)
            metrics = evaluate_predictions(
                task, ds.samples[:EVAL_CHECK], preds, boxes,
                tmp / f"check_{device}", "val")
            outs[device, task] = preds, boxes, metrics
        del eng
    rec = {"samples_per_task": EVAL_CHECK, "dtype": "float32", "tol": 1e-3}
    for task in EVAL_CHECK_TASKS:
        (cp, cb, cm), (pp, pb, pm) = outs["cuda", task], outs["cpu", task]
        if len(cp) != EVAL_CHECK or cp != pp:
            fail(f"eval card vs cpu {task}: answers differ {cp} {pp}")
        for key in ("boxes", "relevance"):
            err = max(float(np.abs(cb[k][key] - pb[k][key]).max())
                      for k in cb)
            rec[f"{task}_{key}_max_abs_err"] = err
            if not err <= 1e-3:
                fail(f"eval card vs cpu {task} {key}: {err} > 1e-3")
        if cm != pm:
            fail(f"eval card vs cpu {task}: metrics differ {cm} {pm}")
    return rec


def _loader_pass(ds, loader: dict) -> dict:
    """Iterate the padded batches of `ds` without predicting: images/s
    over the whole pass, the seconds to the first batch (pool start and
    one batch's items on one worker) and images/s after it."""
    from gpv_tpu_torch.infer.predictions import iter_padded_batches
    t0 = time.perf_counter()
    n, first = 0, None
    for _, n_real in iter_padded_batches(ds, B, **loader):
        n += n_real
        if first is None:
            first, n_first = time.perf_counter() - t0, n_real
    total = time.perf_counter() - t0
    return {"images": n, "images_per_s": n / total, "first_batch_s": first,
            "after_first_images_per_s": (n - n_first) / (total - first)
            if total > first else None}


def _eval_steady(eng, ds, task: str, loader: dict) -> dict:
    """`ds`'s samples EVAL_STEADY_REPEATS times over, with fresh ids, so
    that the loader's start is a small part of the run: the loader alone
    and the pipeline (greedy), images/s."""
    import copy

    import torch
    from gpv_tpu_torch.evaluation.evaluators import TASK_TO_ID_FIELD
    from gpv_tpu_torch.infer.predictions import predict_dataset
    big = copy.copy(ds)
    big.samples = [dict(s, **{TASK_TO_ID_FIELD[task]: k + 1}) for k, s in
                   enumerate(ds.samples * EVAL_STEADY_REPEATS)]
    rec = {"task": task, "samples": len(big),
           "loader": _loader_pass(big, loader)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    preds, _ = predict_dataset(eng, big, task, B, **loader)
    torch.cuda.synchronize()
    rec["pipeline_images_per_s"] = len(preds) / (time.perf_counter() - t0)
    if len(preds) != len(big):
        fail(f"eval steady: {len(preds)} predictions for {len(big)}")
    return rec


def _eval_native(recorder, tmp: Path, checked: set, loader: dict) -> list:
    """Every task's samples again, greedy, resized by the native runtime
    (the exact resize refused, in the forked loaders too): the loader
    alone, the pipeline and a profiled repeat's idle share. Gates: every
    sample predicted once, boxes well formed, launches by variant as the
    batches say, every shape a `kernels` case."""
    import torch
    from gpv_tpu_torch.infer.predictions import predict_dataset
    runs = []
    with numpy_and_exact_paths_refused():
        datasets = eval_datasets(tmp / "data", "native")
        for task, ds in datasets.items():
            def run():
                return predict_dataset(recorder, ds, task, B, **loader)
            lp = _loader_pass(ds, loader)
            torch.cuda.synchronize()
            recorder.calls.clear()
            _reset_counts()
            t0 = time.perf_counter()
            preds, boxes = run()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            _, by_var = _read_counts()
            counts = recorder.launches()
            name = f"eval native {task}"
            _check_counts(name, by_var, counts)
            if {c.name for c in counts} - checked:
                fail(f"{name}: a shape is not a kernels case")
            if len(preds) != len(ds) or len(boxes) != len(ds):
                fail(f"{name}: {len(preds)} predictions for {len(ds)}")
            _check_boxes(boxes.values())
            recorder.calls.clear()
            prof = phase_profile(f"{name} profile", run, recorder.launches)
            runs.append({
                "task": task, "samples": len(ds),
                "loader_images_per_s": lp["images_per_s"],
                "loader_first_batch_s": lp["first_batch_s"],
                "pipeline_images_per_s": len(ds) / wall_s,
                "device_idle_share": prof["device_idle_share"],
                "launches_by_variant": by_var})
    return runs


def phase_eval(eng, vocab_path: Path, tmp: Path, checked: set):
    """Offline evaluation through `infer.predictions` at B=20 over seeded
    COCO-schema datasets of every task (EVAL_SAMPLES each: five full
    batches and one padded), loaded by EVAL_WORKERS forked processes with
    the exact resize: greedy for every task, beam K=BEAM for VQA and
    captioning, each run's predictions scored by the task's evaluator on
    the in-memory boxes. Per run: one item's host cost, the loader
    alone, the pipeline, the evaluator, and a profiled repeat (device idle
    share); then VQA eight times over (the loader's start amortised).
    Gates: every
    sample predicted once, no padded row kept; metrics with the JAX
    evaluators' keys and finite values; launches by variant as the
    batches the run made say (greedy steps per batch read from the
    engine), fp32 none, every shape a `kernels` case; threads and
    processes give the same predictions; fp32 card against CPU.
    Returns the record and the phase's {Case: launches}."""
    import torch
    from gpv_tpu_torch.evaluation.evaluators import TASK_TO_ID_FIELD
    from gpv_tpu_torch.infer.predictions import (evaluate_predictions,
                                                 predict_dataset)

    t_phase = time.perf_counter()
    datasets = eval_datasets(tmp / "data")
    recorder = _Recorder(eng)
    loader = {"num_workers": EVAL_WORKERS, "loader": "processes"}
    phase_run, phase_variants, runs = Counter(), None, []
    loader_ips, host_ms = {}, {}
    for task, beam in [(t, None) for t in EVAL_TASKS] + [
            (t, BEAM) for t in EVAL_BEAM_TASKS]:
        ds = datasets[task]
        n = len(ds)
        if task not in loader_ips:
            # one item's host cost (pixels, crop, exact resize) on one
            # core, after a first call that imports what the resize needs
            ds.get(0, np.random.RandomState(0))
            t0 = time.perf_counter()
            for i in range(EVAL_HOST_ITEMS):
                ds.get(i, np.random.RandomState(i))
            host_ms[task] = 1e3 * (time.perf_counter() - t0) \
                / EVAL_HOST_ITEMS
            loader_ips[task] = _loader_pass(ds, loader)

        def run():
            return predict_dataset(recorder, ds, task, B, beam_size=beam,
                                   **loader)
        torch.cuda.synchronize()
        recorder.calls.clear()
        _reset_counts()
        t0 = time.perf_counter()
        preds, boxes = run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        _, by_var = _read_counts()
        counts = recorder.launches()
        name = f"eval {task}{'' if beam is None else f' K={beam}'}"
        _check_counts(name, by_var, counts)
        unchecked = {c.name for c in counts} - checked
        if unchecked:
            fail(f"{name}: shapes not held against their plain version in "
                 f"the kernels phase: {sorted(unchecked)}")
        rows = [r for _, r, _, _ in recorder.calls]
        ids = [s[TASK_TO_ID_FIELD[task]] for s in ds.samples]
        if rows != [B] * -(-n // B) or list(preds) != ids \
                or list(boxes) != [str(i) for i in ids]:
            fail(f"{name}: batches {rows}, {len(preds)} predictions for "
                 f"{n} samples")
        _check_boxes(boxes.values())
        if beam and any(len(p["answers"]) != beam for p in preds.values()):
            fail(f"{name}: not {beam} answers a sample")
        steps = [s for *_, s in recorder.calls]
        t0 = time.perf_counter()
        metrics = evaluate_predictions(task, ds.samples, preds, boxes,
                                       tmp / "eval", "val")
        eval_s = time.perf_counter() - t0
        _check_metrics(task, metrics)
        phase_run.update(counts)
        phase_variants = by_var if phase_variants is None else {
            w: {v: phase_variants[w][v] + k for v, k in vs.items()}
            for w, vs in by_var.items()}
        recorder.calls.clear()
        prof = phase_profile(f"{name} profile", run, recorder.launches)
        runs.append({
            "task": task, "beam_size": beam, "samples": n,
            "batches": len(rows), "decode_steps": steps,
            "host_ms_per_item": host_ms[task],
            "loader_images_per_s": loader_ips[task]["images_per_s"],
            "loader_first_batch_s": loader_ips[task]["first_batch_s"],
            "pipeline_images_per_s": n / wall_s, "pipeline_s": wall_s,
            "evaluator_s": eval_s,
            "device_idle_share": prof["device_idle_share"],
            "profile_wall_ms": prof["wall_ms"],
            "device_busy_ms": prof["device_busy_ms"],
            "port_kernels": prof["port_kernels"],
            "launches_by_variant": by_var,
            "metrics_everything": metrics["everything"],
            "answers": [preds[i]["answer"] for i in ids[:2]]})
        if task == EVAL_LOADER_TASK and beam is None:
            ref = (preds, boxes)
    # the same task with threads: the same predictions
    task = EVAL_LOADER_TASK
    t0 = time.perf_counter()
    preds, boxes = predict_dataset(eng, datasets[task], task, B,
                                   num_workers=EVAL_WORKERS,
                                   loader="threads")
    threads_s = time.perf_counter() - t0
    box_err = max(float(np.abs(boxes[k][f] - ref[1][k][f]).max())
                  for k in boxes for f in ("boxes", "relevance"))
    if preds != ref[0] or box_err != 0:
        fail(f"eval {task}: threads and processes differ (boxes, "
             f"relevance max abs {box_err})")
    rec = {"phase": "eval", "batch": B, "dtype": "bfloat16",
           "workers": EVAL_WORKERS, "host_resize": "exact",
           "images": sum(r["samples"] for r in runs), "runs": runs,
           "launches_by_variant": phase_variants,
           "threads_equal_processes": EVAL_LOADER_TASK,
           "threads_pipeline_images_per_s": len(preds) / threads_s}
    rec["steady"] = _eval_steady(eng, datasets[task], task, loader)
    rec["native"] = _eval_native(recorder, tmp, checked, loader)
    t0 = time.perf_counter()
    rec["card_vs_cpu"] = _eval_card_vs_cpu(vocab_path, datasets, tmp)
    rec["card_vs_cpu"]["seconds"] = time.perf_counter() - t0
    rec["seconds"] = time.perf_counter() - t_phase
    return rec, phase_run


@contextlib.contextmanager
def seeded_pixel_datasets():
    """Within the block every dataset class the trainer builds supplies
    seeded pixels (`_SeededPixels`): the card machine has no JPEGs."""
    from gpv_tpu_torch.datasets import coco
    saved = dict(coco.DATASET_CLASSES)
    coco.DATASET_CLASSES.update(
        {k: type(c.__name__, (_SeededPixels, c), {}) for k, c in
         saved.items()})
    try:
        yield
    finally:
        coco.DATASET_CLASSES.update(saved)


def train_config(data_dir: Path, vocab_path: Path, *extra):
    """`configs/exp/gpv.yaml` for the train phases, and the seeded train
    and val samples of each task written where it reads them."""
    from gpv_tpu_torch.utils.config import load_config
    cfg = load_config(ROOT / "configs", "exp/gpv", [
        f"data_dir={data_dir}", f"output_dir={data_dir / 'exp'}",
        "exp_name=train", "learning_datasets=all",
        "task_configs.host_resize=exact", f"model.vocab={vocab_path}",
        f"training.batch_size={TRAIN_B}", "training.query_dedup=true",
        "training.run_vis_at_launch=false", "tb_dir=null",
        "training.num_val_samples={coco_vqa: %d, coco_cap: %d, "
        "coco_det: %d, coco_cls: %d}" % ((TRAIN_VAL,) * 4),
        "device=cuda"] + list(extra))
    for task in TRAIN_TASKS:
        samples = cfg.task_configs[EVAL_TASKS[task]].samples
        for subset, n in (("train", TRAIN_SAMPLES), ("val", TRAIN_VAL)):
            path = Path(samples[subset])
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(eval_samples(task, n)))
    return cfg


def _finite_losses(phase: str, losses: dict) -> dict:
    out = {k: float(v) for k, v in losses.items()}
    if set(out) != TRAIN_LOSS_KEYS or not all(map(np.isfinite,
                                                  out.values())):
        fail(f"{phase}: loss keys {sorted(out)} or a value not finite: "
             f"{out}")
    return out


def _first_step(trainer, batch, cfg) -> int:
    """Run the first step at the smallest grad_accum_steps that fits: the
    trainer's own step (the config's 1), else a step rebuilt at 2, 4, 8."""
    import torch
    from gpv_tpu_torch.losses.criterion import LossConfig
    from gpv_tpu_torch.parallel.train_step import make_train_step
    for accum in TRAIN_ACCUM:
        if accum > int(cfg.training.grad_accum_steps):
            trainer.train_step = make_train_step(
                trainer.model, LossConfig.from_config(cfg.losses),
                float(cfg.training.clip_max_norm), grad_accum=accum,
                dtype=trainer.dtype)
        try:
            _finite_losses("train", trainer.train_step(trainer.state, batch))
            return accum
        except torch.cuda.OutOfMemoryError:
            trainer.state.optimizer.zero_grad(set_to_none=True)
            torch.cuda.empty_cache()
    fail(f"train: batch {TRAIN_B} does not fit at grad_accum "
         f"{TRAIN_ACCUM[-1]}")


def _state_copy(state) -> tuple:
    """Copies of the model's and the optimizer's tensors, on the card."""
    opt = state.optimizer.state_dict()
    return ({k: v.detach().clone() for k, v in
             state.model.state_dict().items()},
            {i: {k: v.clone() if hasattr(v, "clone") else v
                 for k, v in s.items()} for i, s in opt["state"].items()},
            state.step)


def _matcher_ms(model, batch, dtype):
    """The matcher's parts on one forward's predictions: cost matrices on
    the card, their copy to the host, the native solve. Returns the times
    and the host costs."""
    import torch
    from gpv_tpu_torch.ops.image import normalize_image
    from gpv_tpu_torch.ops.matcher import match_costs, solve_costs
    with torch.no_grad(), torch.autocast("cuda", dtype=dtype):
        out = model(normalize_image(batch["image"].float() / 255.0),
                    batch["query_ids"], batch["answer_ids"],
                    query_valid=batch["query_valid"], train=True)
    valid = batch["box_valid"] & batch["has_boxes"][:, None]
    times = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    costs = match_costs(out["pred_relevance_logits"], out["pred_boxes"],
                        batch["box_labels"], batch["boxes"], valid)
    torch.cuda.synchronize()
    times["cost_ms"] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    host = costs.cpu().numpy()
    times["copy_ms"] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    solve_costs(host)
    times["solve_ms"] = 1e3 * (time.perf_counter() - t0)
    times["shape"] = list(host.shape)
    return times, host


def phase_train(vocab_path: Path, tmp: Path, checked: set):
    """The training path at released width through `Trainer` (module
    docstring). Returns the record, the {Case: launches} of one step, the
    in-train eval's record and launches, and one loaded batch (numpy)."""
    import torch
    from gpv_tpu_torch.parallel.train_step import batch_to_device
    from gpv_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    cfg = train_config(tmp / "train_data", vocab_path)
    rec = {"phase": "train", "batch": TRAIN_B, "dtype": "bfloat16",
           "image_hw": [IMG_H, IMG_W], "workers": int(
               cfg.training.num_workers), "host_resize": "exact"}
    with seeded_pixel_datasets():
        t0 = time.perf_counter()
        trainer = Trainer(cfg)
        rec["setup_s"] = time.perf_counter() - t0
        model = trainer.model
        frozen = {n for n, p in model.named_parameters()
                  if not p.requires_grad}
        want = {n for n, _ in model.named_parameters()
                if n.startswith(FROZEN_PREFIXES)}
        if frozen != want:
            fail(f"train: frozen {sorted(frozen ^ want)[:6]} differ from "
                 "BERT, the stem, the tokens and the vocab embedding")
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        batches = iter(trainer.loaders["train"])
        waits, rows, steps_s = [], [], []
        for i in range(TRAIN_WARMUP + TRAIN_STEPS):
            t0 = time.perf_counter()
            batch = next(batches)
            waits.append(1e3 * (time.perf_counter() - t0))
            rows.append(len(batch["query_uniq_ids"]))
            if i == 0:
                rec["grad_accum_steps"] = _first_step(trainer, batch, cfg)
            else:
                if i == TRAIN_WARMUP:
                    torch.cuda.synchronize()
                    _reset_counts()
                    torch.cuda.reset_peak_memory_stats()
                    t_timed = time.perf_counter()
                t0 = time.perf_counter()
                losses = trainer.train_step(trainer.state, batch)
                steps_s.append(time.perf_counter() - t0)
            trainer.step += 1
        torch.cuda.synchronize()
        timed_s = time.perf_counter() - t_timed
        batches.close()  # stops the loader's workers
        rec["losses"] = _finite_losses("train", losses)
        _, by_var = _read_counts()
        counts = Counter()
        for u in rows[TRAIN_WARMUP:]:
            counts.update(train_step_launches(u, True))
        _check_counts("train", by_var, counts)
        unchecked = {c.name for c in counts} - checked
        if unchecked:
            fail(f"train: shapes not held against their plain version in "
                 f"the kernels phase: {sorted(unchecked)}")
        rec.update({"dedup_rows": rows, "launches_by_variant": by_var,
                    "loader_wait_ms": waits,
                    "images_per_s_with_loader":
                        TRAIN_STEPS * TRAIN_B / timed_s,
                    "timed_step_s": steps_s})
        for name, p in model.named_parameters():
            same = torch.equal(p.detach(), start[name])
            if same != (name in frozen):
                fail(f"train: {name} {'did not change' if same else 'changed'}"
                     " over the steps")
        del start

        # one resident batch: the card alone, then split and profiled
        resident = batch_to_device(batch, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TRAIN_RESIDENT):
            trainer.train_step(trainer.state, resident)
        torch.cuda.synchronize()
        rec["images_per_s_resident"] = TRAIN_RESIDENT * TRAIN_B / (
            time.perf_counter() - t0)
        split = {}  # from the host batch: the upload is part of it
        trainer.train_step(trainer.state, batch, timings=split)
        rec["step_ms_by_stage"] = split
        rec["step_ms"] = sum(split.values())
        rec["matcher"], costs = _matcher_ms(model, resident, trainer.dtype)
        one_step = train_step_launches(rows[-1], True)
        prof = phase_profile(
            "train_profile",
            lambda: trainer.train_step(trainer.state, resident), one_step)
        rec["profile"] = {k: prof[k] for k in (
            "wall_ms", "device_busy_ms", "device_idle_share",
            "ms_by_group", "port_kernels", "top_kernels")}
        rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        del resident

        # in-train eval through a recording engine
        recorder = _Recorder(trainer.engine)
        trainer.engine = recorder
        _reset_counts()
        t0 = time.perf_counter()
        results = trainer.evaluate("val")
        torch.cuda.synchronize()
        ev = {"eval_s": time.perf_counter() - t0, "results": results}
        trainer.engine = recorder.eng
        _, ev_var = _read_counts()
        ev_counts = recorder.launches()
        _check_counts("train eval", ev_var, ev_counts)
        if {c.name for c in ev_counts} - checked:
            fail("train eval: a shape is not a kernels case")
        if set(results) != TRAIN_EVAL_KEYS or not all(
                map(np.isfinite, results.values())):
            fail(f"train eval: keys {sorted(results)} or a value not "
                 f"finite: {results}")
        ev.update(launches_by_variant=ev_var,
                  batches=len(recorder.calls))

        # save, move on one step, resume: the saved state comes back
        saved = _state_copy(trainer.state)
        t0 = time.perf_counter()
        trainer.save(0, results)
        rec["save_s"] = time.perf_counter() - t0
        trainer.train_step(trainer.state, batch)
        t0 = time.perf_counter()
        trainer._resume(Path(cfg.ckpt_dir) / "model")
        rec["resume_s"] = time.perf_counter() - t0
        back = _state_copy(trainer.state)
        if back[2] != saved[2] or any(
                not torch.equal(back[0][k], v) for k, v in saved[0].items()):
            fail("train: the resumed model differs from the saved one")
        for i, s in saved[1].items():
            for k, v in s.items():
                if not torch.equal(torch.as_tensor(back[1][i][k]),
                                   torch.as_tensor(v)):
                    fail(f"train: resumed optimizer state {i}.{k} differs")
        rec["resume_equal"] = True
        del trainer, model, saved, back
    torch.cuda.empty_cache()
    rec["eval"] = ev
    rec["seconds"] = time.perf_counter() - t_phase
    return rec, one_step, ev, ev_counts, batch, costs


@contextlib.contextmanager
def numpy_and_exact_paths_refused():
    """Within the block the numpy jitter and the exact resize raise, here
    and in the loader workers forked here: a batch that one of them built
    fails the run."""
    from gpv_tpu_torch.data import skimage_resize
    from gpv_tpu_torch.datasets import transforms

    def refused(*args, **kwargs):
        raise RuntimeError("the numpy jitter or the exact resize ran on "
                           "the native path")
    saved = [(m, n, getattr(m, n)) for m, n in (
        (transforms, "adjust_brightness"), (transforms, "adjust_contrast"),
        (transforms, "adjust_saturation"), (transforms, "adjust_hue"),
        (transforms, "_grayscale"),
        (skimage_resize, "skimage_resize_exact"))]
    for m, n, _ in saved:
        setattr(m, n, refused)
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def _count_native(loader) -> None:
    """Every batch `loader` makes carries `native_calls`: the native
    resizes and jitters its items ran, counted in the process that made
    them (a forked worker)."""
    from gpv_tpu_torch import native
    fns = (native.resize_bilinear_native, native.color_jitter_native)
    make = loader.load_batch

    def load_batch(bi, idxs, epoch):
        before = [f.calls for f in fns]
        batch = make(bi, idxs, epoch)
        batch["native_calls"] = np.array(
            [f.calls - b for f, b in zip(fns, before)])
        return batch
    loader.load_batch = load_batch


def _native_batch(batches, phase: str) -> dict:
    """The next batch, gated on its `native_calls`: every item resized
    natively, and the fused jitter ran."""
    batch = next(batches)
    resized, jittered = batch.pop("native_calls")
    if resized != TRAIN_B or not jittered > 0:
        fail(f"{phase}: a batch of {TRAIN_B} made {resized} native resizes "
             f"and {jittered} fused jitters")
    return batch


def _adam_by_name(state) -> dict:
    names = {id(p): n for n, p in state.model.named_parameters()}
    return {names[id(p)]: s for p, s in state.optimizer.state.items()}


def _grouped(state) -> set:
    names = {id(p): n for n, p in state.model.named_parameters()}
    return {names[id(p)] for g in state.optimizer.param_groups
            for p in g["params"]}


def write_detr_pth(path: Path, cfg, vocab_len: int) -> Path:
    """A seeded DETR checkpoint at the released widths under the reference
    names, as the released `detr_coco.pth` holds them: COCO's 92-way
    `class_embed`, so that one leaf does not load and keeps training."""
    import torch
    from gpv_tpu_torch.models.gpv import build_gpv
    from gpv_tpu_torch.weights import init_random
    sd = dict(init_random(build_gpv(cfg.model, vocab_len), seed=7)
              .detr.state_dict())
    g = torch.Generator().manual_seed(7)
    dim = sd["class_embed.weight"].shape[1]
    sd["class_embed.weight"] = 0.02 * torch.randn(92, dim, generator=g)
    sd["class_embed.bias"] = torch.zeros(92)
    torch.save({"model": sd}, path)
    return path


def _train_item_ms(data: Path, vocab_path: Path, n: int = 12) -> dict:
    """One train item's host ms on one core, averaged over `n` items of
    every task: the seeded pixels alone (what a JPEG decode stands for),
    the item with the native resize and fused jitter, and with the exact
    resize and the numpy jitter."""
    import functools

    from gpv_tpu_torch.datasets import transforms
    from gpv_tpu_torch.datasets.coco import CocoMultitaskDataset
    out = {}
    calls = [(c, c.__call__) for c in (transforms.ColorJitter,
                                       transforms.RandomGrayscale)]
    with seeded_pixel_datasets():
        for resize, jitter in (("native", True), ("exact", False)):
            cfg = train_config(data, vocab_path,
                               f"task_configs.host_resize={resize}")
            ds = CocoMultitaskDataset(cfg.learning_datasets,
                                      cfg.task_configs, "train", True)
            for c, call in calls:
                c.__call__ = functools.partialmethod(call, native=jitter)
            try:
                ds.get(0, np.random.RandomState(0))
                t0 = time.perf_counter()
                for i in range(1, n + 1):
                    ds.get(i * 97 % len(ds), np.random.RandomState(i))
                out[f"{resize}_resize_{'fused' if jitter else 'numpy'}"
                    "_jitter"] = 1e3 * (time.perf_counter() - t0) / n
            finally:
                for c, call in calls:
                    c.__call__ = call
        sub = ds.datasets[0]
        t0 = time.perf_counter()
        for sample in sub.samples[:n]:
            sub.load_pixels(sample)
        out["seeded_pixels"] = 1e3 * (time.perf_counter() - t0) / n
    return out


def phase_train_native(vocab_path: Path, tmp: Path, train_rec: dict,
                       costs: np.ndarray):
    """The two-phase recipe (scripts/train.sh) at released width with the
    native resize and the fused jitter, then the native loader's rate.
    Phase 1: `training.freeze` with a seeded `model.pretr_detr`, 2 steps,
    saved. Phase 2: the same trainer config as `train` resuming phase 1's
    `ckpts/model` with the freeze off. Gates: the model equals the saved
    one; the carried AdamW state equals the saved one bit for bit; the
    newly unfrozen leaves start from empty state, take their first step
    and move (those with a gradient); the step and epoch are restored; the
    lr is the schedule's at the restored step; every batch built by the
    native resize and jitter (numpy and exact paths refused). Then 2
    warm-up and 5 timed phase-2 steps through the loader, beside `train`'s
    exact-resize rate; and the native matcher solve against scipy's loop
    on the train phase's costs (every image's total within 1e-5
    relative). Returns the two-phase record and the `train_native`
    record."""
    import torch
    from scipy.optimize import linear_sum_assignment

    from gpv_tpu_torch.ops.matcher import solve_costs
    from gpv_tpu_torch.text.vocab import AnswerVocab
    from gpv_tpu_torch.train.optimizer import make_schedule
    from gpv_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    data = tmp / "two_phase"
    native = "task_configs.host_resize=native"
    cfg1 = train_config(data, vocab_path, native, "training.freeze=true")
    pth = write_detr_pth(tmp / "detr.pth", cfg1,
                         len(AnswerVocab.load(vocab_path)))
    cfg1 = train_config(data, vocab_path, native, "training.freeze=true",
                        f"model.pretr_detr={pth}")
    two = {"steps_phase1": 2}
    with seeded_pixel_datasets(), numpy_and_exact_paths_refused():
        t0 = time.perf_counter()
        one = Trainer(cfg1)
        two["setup_s"] = time.perf_counter() - t0
        _count_native(one.loaders["train"])
        batches = iter(one.loaders["train"])
        for _ in range(two["steps_phase1"]):
            _finite_losses("train_native phase 1", one.train_step(
                one.state, _native_batch(batches, "phase 1")))
            one.step += 1
        batches.close()
        one.save(0, {"model_selection_metric": 0.0})
        frozen1 = {n for n, p in one.model.named_parameters()
                   if not p.requires_grad}
        two["frozen_phase1"] = len(frozen1)
        if "detr.class_embed.weight" in frozen1 or not any(
                n.startswith("detr.transformer.") for n in frozen1):
            fail("train_native: phase 1 froze other leaves than the loaded "
                 "DETR ones")

        cfg2 = train_config(data, vocab_path, native,
                            f"training.ckpt={Path(cfg1.ckpt_dir) / 'model'}")
        t0 = time.perf_counter()
        tr = Trainer(cfg2)
        two["resume_setup_s"] = time.perf_counter() - t0
        for name, t in one.model.state_dict().items():
            if not torch.equal(tr.model.state_dict()[name], t):
                fail(f"train_native: phase 2's {name} differs from the "
                     "saved one")
        s1, s2 = _adam_by_name(one.state), _adam_by_name(tr.state)
        if set(s1) != set(s2) or set(s1) != _grouped(one.state):
            fail("train_native: phase 2's AdamW state covers other leaves "
                 "than phase 1's groups")
        for name, want in s1.items():
            for key, t in want.items():
                if not torch.equal(s2[name][key], t):
                    fail(f"train_native: carried {name}.{key} differs")
        unfrozen = _grouped(tr.state) - _grouped(one.state)
        two.update(carried=len(s1), unfrozen=len(unfrozen))
        if unfrozen != frozen1 & _grouped(tr.state) or not any(
                n.startswith("detr.transformer.") for n in unfrozen):
            fail("train_native: phase 2 unfroze other leaves than phase 1's "
                 "frozen DETR ones")
        if (tr.step, tr.state.step, tr.last_epoch) != (2, 2, 0):
            fail(f"train_native: step {tr.step}/{tr.state.step}, epoch "
                 f"{tr.last_epoch} after the resume")
        lam = make_schedule(cfg2.training, len(tr.loaders["train"]))
        base = {"detr_backbone": float(cfg2.training.lr_backbone)}
        for g in tr.state.optimizer.param_groups:
            want = base.get(g["name"], float(cfg2.training.lr)) * lam(2)
            if abs(g["lr"] - want) > 1e-12 * want:
                fail(f"train_native: group {g['name']} lr {g['lr']} is not "
                     f"the schedule's {want} at step 2")
        del one, s1, s2
        torch.cuda.empty_cache()

        _count_native(tr.loaders["train"])
        start = {n: tr.model.get_parameter(n).detach().clone()
                 for n in unfrozen}
        batches = iter(tr.loaders["train"])
        waits, steps_s = [], []
        for i in range(TRAIN_WARMUP + TRAIN_STEPS):
            t0 = time.perf_counter()
            batch = _native_batch(batches, "phase 2")
            waits.append(1e3 * (time.perf_counter() - t0))
            if i == TRAIN_WARMUP:
                torch.cuda.synchronize()
                t_timed = time.perf_counter()
            t0 = time.perf_counter()
            losses = tr.train_step(tr.state, batch)
            steps_s.append(time.perf_counter() - t0)
            tr.step += 1
            if i == 0:
                state, moved = _adam_by_name(tr.state), 0
                for n, t in start.items():
                    p = tr.model.get_parameter(n)
                    if int(state[n]["step"]) != 1:
                        fail(f"train_native: unfrozen {n} did not start "
                             "from empty state")
                    if torch.count_nonzero(p.grad):
                        if torch.equal(p.detach(), t):
                            fail(f"train_native: unfrozen {n} did not move")
                        moved += 1
                two["unfrozen_moved"] = moved
                del start, state
        torch.cuda.synchronize()
        timed_s = time.perf_counter() - t_timed
        batches.close()
        _finite_losses("train_native", losses)
        del tr
    torch.cuda.empty_cache()
    two["seconds"] = time.perf_counter() - t_phase
    host = _train_item_ms(data, vocab_path)

    # the matcher: one native call against scipy's per-image loop
    t0 = time.perf_counter()
    got = solve_costs(costs)
    native_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    ref = [linear_sum_assignment(c) for c in costs]
    scipy_ms = 1e3 * (time.perf_counter() - t0)
    worst = 0.0
    for c, q4t, (rows, cols) in zip(costs, got, ref):
        a = float(c[np.arange(len(q4t)), q4t].sum())
        b = float(c[rows, cols].sum())
        worst = max(worst, abs(a - b) / max(abs(b), 1e-6))
    if not worst <= 1e-5:
        fail(f"train_native: a native assignment's total is {worst} "
             "relative off scipy's optimum")
    rec = {"phase": "train_native", "batch": TRAIN_B,
           "host_resize": "native", "jitter": "fused C++",
           "workers": int(cfg2.training.num_workers),
           "loader_wait_ms": waits, "timed_step_s": steps_s,
           "images_per_s_with_loader": TRAIN_STEPS * TRAIN_B / timed_s,
           "exact_images_per_s_with_loader":
               train_rec["images_per_s_with_loader"],
           "exact_loader_wait_ms": train_rec["loader_wait_ms"],
           "host_ms_per_item": host,
           "matcher": {"shape": list(costs.shape), "native_solve_ms":
                       native_ms, "scipy_solve_ms": scipy_ms,
                       "total_cost_max_rel_err": worst, "tol": 1e-5},
           "seconds": time.perf_counter() - t_phase}
    return two, rec


def phase_train_e2e(vocab_path: Path, tmp: Path, batch: dict) -> dict:
    """One fp32 train step (TF32 off) on the card and on the CPU from the
    same seeded weights at dropout 0, on the first E2E_TRAIN_B rows of a
    loaded batch without the dedup fields (so BERT runs in the forward):
    the losses, the assignment and the clipped gradients."""
    import copy

    import torch
    from gpv_tpu_torch.losses.criterion import LossConfig
    from gpv_tpu_torch.models.gpv import build_gpv
    from gpv_tpu_torch.ops.image import normalize_image
    from gpv_tpu_torch.ops.matcher import hungarian_match
    from gpv_tpu_torch.parallel.train_step import (TrainState,
                                                   batch_to_device,
                                                   make_train_step)
    from gpv_tpu_torch.text.vocab import AnswerVocab
    from gpv_tpu_torch.train.optimizer import build_optimizer
    from gpv_tpu_torch.weights import init_random

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = train_config(tmp / "train_data", vocab_path, "tpu.dtype=float32",
                       "model.detr.dropout=0.0")
    base = init_random(build_gpv(cfg.model, len(AnswerVocab.load(
        vocab_path))), seed=1)
    rows = {k: v[:E2E_TRAIN_B] for k, v in batch.items()
            if not k.startswith("query_uniq") and k != "query_gather"}
    out = {}
    for device in ("cuda", "cpu"):
        model = copy.deepcopy(base).to(device)
        b = batch_to_device(rows, device)
        with torch.no_grad():
            pred = model(normalize_image(b["image"].float() / 255.0),
                         b["query_ids"], b["answer_ids"],
                         query_valid=b["query_valid"], train=True)
        q4t = hungarian_match(pred["pred_relevance_logits"],
                              pred["pred_boxes"], b["box_labels"],
                              b["boxes"], b["box_valid"]
                              & b["has_boxes"][:, None]).cpu()
        opt, sched = build_optimizer(cfg.training, 10, model)
        step = make_train_step(model, LossConfig.from_config(cfg.losses),
                               float(cfg.training.clip_max_norm))
        _reset_counts()
        losses = step(TrainState(model, opt, sched), rows)
        out[device] = {
            "losses": {k: float(v) for k, v in losses.items()},
            "q4t": q4t, "valid": (b["box_valid"]
                                  & b["has_boxes"][:, None]).cpu(),
            "launches": _read_counts()[1],
            "grads": {n: p.grad.detach().cpu()
                      for n, p in model.named_parameters()
                      if p.grad is not None}}
        del model, opt, b
    torch.cuda.empty_cache()
    c, p = out["cuda"], out["cpu"]
    rec = {"phase": "train_e2e", "batch": E2E_TRAIN_B, "dtype": "float32",
           "losses_cuda": c["losses"], "launches_cuda": c["launches"]}
    want = by_variant(train_step_launches(E2E_TRAIN_B, False))
    want["fused_attention"]["fp32"] = want["fused_attention"].pop("tile")
    want["fused_attention"]["tile"] = 0
    if c["launches"] != want:
        fail(f"train_e2e: launches {c['launches']} != {want}")
    _finite_losses("train_e2e", c["losses"])
    rel = max(abs(c["losses"][k] - v) / max(abs(v), 1e-6)
              for k, v in p["losses"].items())
    rec["loss_max_rel_err"], rec["loss_tol"] = rel, 1e-4
    if not rel <= 1e-4:
        fail(f"train_e2e: losses card {c['losses']} cpu {p['losses']}")
    if not torch.equal(torch.where(c["valid"], c["q4t"], -1),
                       torch.where(p["valid"], p["q4t"], -1)):
        fail("train_e2e: the assignments differ")
    rec["assignment_equal"] = True
    if set(c["grads"]) != set(p["grads"]):
        fail("train_e2e: the card and the CPU have other gradient leaves")
    worst, name = 0.0, None
    for n, g in p["grads"].items():
        err = (c["grads"][n] - g).abs().max().item() / max(
            1.0, g.abs().max().item())
        if err > worst:
            worst, name = err, n
    rec["grad_max_err"], rec["grad_worst_leaf"] = worst, name
    rec["grad_tol"] = 1e-3
    if not worst <= 1e-3:
        fail(f"train_e2e: gradient of {name} differs by {worst} x "
             "max(1, max|g|)")
    rec["seconds"] = time.perf_counter() - t_phase
    return rec


EXPORT_BUCKETS, EXPORT_FP32_B, EXPORT_PAD_N = SERVE_BUCKETS, 4, 5
EXPORT_CLIENTS, EXPORT_REQUESTS = 10, 10
# run in a fresh process: load the bundle without the model code, predict
# the slice's seeded batch (B) and a batch of EXPORT_PAD_N, with the
# kernels' launches by variant read around each call
_EXPORT_LOADER = """
import json, sys, time
sys.path.insert(0, sys.argv[2])
import torch
import chip_smoke as cs
from gpv_tpu_torch.export import ExportedEngine
eng = ExportedEngine(sys.argv[1])
images, queries = cs._batch(0, cs.B)
runs = {}
for n in (cs.B, cs.EXPORT_PAD_N):
    eng.predict(images[:n], queries[:n])  # warm-up
    torch.cuda.synchronize()
    cs._reset_counts()
    out = eng.predict(images[:n], queries[:n])
    torch.cuda.synchronize()
    runs[n] = {"answers": [o["answer"] for o in out],
               "boxes": [o["boxes"].tolist() for o in out],
               "relevance": [o["relevance"].tolist() for o in out],
               "steps": eng.last_decode_steps,
               "launches_by_variant": cs._read_counts()[1]}
ips = cs._images_per_s(lambda: eng.predict(images, queries), 5)
leaked = sorted(m for m in sys.modules if m.split(".")[:2] in (
    ["gpv_tpu_torch", "models"], ["gpv_tpu_torch", "nn"],
    ["gpv_tpu_torch", "weights"], ["gpv_tpu_torch", "infer"]))
print(json.dumps({"runs": runs, "images_per_s": ips, "leaked": leaked}))
"""


def _agree(phase: str, got, want, tol: float) -> float:
    """Answers equal; boxes and relevance within tol x max(1, max|ref|).
    Returns the worst scaled error."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if g["answer"] != w["answer"]:
            fail(f"{phase}: answer {i} {g['answer']!r} != {w['answer']!r}")
        for key in ("boxes", "relevance"):
            ref = np.asarray(w[key], np.float64)
            err = float(np.abs(np.asarray(g[key]) - ref).max()) / max(
                1.0, float(np.abs(ref).max()))
            if not err <= tol:
                fail(f"{phase}: {key} {i} off by {err} > {tol}")
            worst = max(worst, err)
    if len(got) != len(want):
        fail(f"{phase}: {len(got)} results for {len(want)}")
    return worst


def phase_export(eng, vocab_path: Path, tmp: Path, checked: set):
    """The bf16 engine exported at buckets EXPORT_BUCKETS (released width):
    seconds per program, bytes on disk (weights stored once: under 1.3x
    the weights file). A fresh process loads the bundle with no model
    module imported and predicts the slice's batch and a batch of
    EXPORT_PAD_N (padded to 8): answers equal to `GPVEngine.predict`'s on
    the same padded rows, boxes and relevance within 2e-2 x
    max(1, max|ref|), launches by
    variant equal to `path_launches` for the steps run, every shape a
    `kernels` case, images/s beside the engine's. Then fp32 (TF32 off) at
    B=EXPORT_FP32_B: answers equal, boxes and relevance within 1e-4. Then
    GPVServer over the bundle: EXPORT_CLIENTS x EXPORT_REQUESTS requests
    all resolved, a beam request refused at the door. Returns the record
    and the B-row run's {Case: launches}."""
    import torch
    from gpv_tpu_torch.export import ExportedEngine, export_engine
    from gpv_tpu_torch.serve import GPVServer

    t_phase = time.perf_counter()
    shapes = {c.name for b in EXPORT_BUCKETS
              for c in path_launches("predict", 0, b)}
    if shapes - checked:
        fail(f"export: shapes not held against their plain version in the "
             f"kernels phase: {sorted(shapes - checked)}")
    out = tmp / "bundle"
    t0 = time.perf_counter()
    manifest = export_engine(eng, out, EXPORT_BUCKETS, (IMG_H, IMG_W))
    rec = {"phase": "export", "buckets": list(EXPORT_BUCKETS),
           "dtype": "bfloat16", "export_s": time.perf_counter() - t0,
           "program_export_s": {k: p["export_s"] for k, p in
                                manifest["programs"].items()}}
    sizes = {f.name: f.stat().st_size for f in out.iterdir()}
    rec["bundle_bytes"], rec["weights_bytes"] = (sum(sizes.values()),
                                                 sizes["weights.pt"])
    rec["bundle_over_weights"] = rec["bundle_bytes"] / rec["weights_bytes"]
    if not rec["bundle_over_weights"] < 1.3:
        fail(f"export: the bundle is {rec['bundle_over_weights']} x its "
             f"weights file: {sizes}")

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _EXPORT_LOADER, str(out),
                           str(ROOT)], capture_output=True, text=True,
                          timeout=600, cwd=str(tmp))
    rec["fresh_process_s"] = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"export: the fresh process failed:\n{proc.stderr[-4000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    if got["leaked"]:
        fail(f"export: loading the bundle imported {got['leaked']}")
    images, queries = _batch(0, B)
    rec["runs"], counts = {}, None
    for n_str, r in got["runs"].items():
        n = int(n_str)
        bucket = min(b for b in EXPORT_BUCKETS if b >= n)
        # the engine on the rows the bundle ran (padded by repetition): in
        # bf16 another batch size may round a near-tie the other way
        pad = [i % n for i in range(bucket)]
        want = eng.predict(images[pad], [queries[i] for i in pad])[:n]
        unpadded = eng.predict(images[:n], queries[:n])
        err = _agree(f"export B={n}", [
            {"answer": a, "boxes": bx, "relevance": rl} for a, bx, rl in
            zip(r["answers"], r["boxes"], r["relevance"])], want, 2e-2)
        run = path_launches("predict", r["steps"], bucket)
        _check_counts(f"export B={n}", r["launches_by_variant"], run)
        rec["runs"][n] = {"bucket": bucket, "decode_steps": r["steps"],
                          "answers_equal_unpadded_engine": sum(
                              a == u["answer"] for a, u in
                              zip(r["answers"], unpadded)),
                          "launches_by_variant": r["launches_by_variant"],
                          "max_scaled_err": err, "tol": 2e-2}
        if n == B:
            counts = run
            rec["launches_by_variant"] = r["launches_by_variant"]
            rec["decode_steps"] = r["steps"]
    rec["images_per_s"] = got["images_per_s"]
    rec["engine_images_per_s"] = _images_per_s(
        lambda: eng.predict(images, queries), 5)

    # fp32, TF32 off: the bundle against its engine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    e32 = make_engine(vocab_path, "float32", "cuda")
    export_engine(e32, tmp / "bundle32", (EXPORT_FP32_B,), (IMG_H, IMG_W))
    x32 = ExportedEngine(tmp / "bundle32")
    imgs, qs = _batch(3, EXPORT_FP32_B)
    rec["fp32"] = {"batch": EXPORT_FP32_B, "tol": 1e-4, "max_scaled_err":
                   _agree("export fp32", x32.predict(imgs, qs),
                          e32.predict(imgs, qs), 1e-4)}
    del e32, x32
    torch.cuda.empty_cache()

    # the server over the bundle
    server = GPVServer(ExportedEngine(out), bucket_sizes=EXPORT_BUCKETS,
                       max_wait_ms=5, num_workers=2, warmup=(IMG_H, IMG_W))
    try:
        server.submit(images[0], queries[0], beam_size=3)
        fail("export: the server took a beam request for a bundle")
    except ValueError:
        rec["beam_refused"] = True
    errors = []

    def client(c: int) -> None:
        for r in range(EXPORT_REQUESTS):
            i = (c * EXPORT_REQUESTS + r) % B
            out = server.submit(images[i], queries[i]).result(timeout=300)
            if out["boxes"].shape != (100, 4):
                errors.append((c, r))
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(EXPORT_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    server.close(drain=True)
    stats = server.stats()
    n = EXPORT_CLIENTS * EXPORT_REQUESTS
    if any(t.is_alive() for t in threads) or errors or not (
            stats["completed"] == stats["submitted"] == n
            and stats["failed"] == 0):
        fail(f"export: served {stats}, errors {errors}")
    rec["serve"] = {"requests": n, "requests_per_s": n / wall,
                    "batches_per_bucket": stats["batches_per_bucket"],
                    "latency_ms": stats["latency_ms"]}
    rec["seconds"] = time.perf_counter() - t_phase
    return rec, counts


def kernels_line(kern: dict, runs: dict) -> dict:
    """One entry per kernel of the paths. Its top-level numbers are one
    predict's (the slice run): each bf16 shape's number times its
    launches in that run, summed over the shapes that kernel serves;
    `paths` holds the same for each measured run (predict, predict_beam,
    embed_vocab, the whole serve run, the eval phase's gated runs). runs:
    path -> (its phase record, {Case: launches})."""
    keys = ("ms", "device_ms", "plain_ms", "plain_device_ms", "library_ms",
            "library_device_ms", "bound_ms", "bytes_ms", "ops_ms")

    def per_call(recs, counts):
        counts = {c.name: n for c, n in counts.items()}
        tot = {k: 0.0 for k in keys}
        for r in recs:
            for k in keys:
                tot[k] += counts.get(r["case"], 0) * (r[k] or 0.0)
        tot["bound_by"] = ("bytes" if tot.pop("bytes_ms") >= tot.pop("ops_ms")
                           else "operations")
        tot["max_abs_err"] = max(r["max_abs_err"] for r in recs)
        return tot

    bf16 = [r for r in kern["K1"] if r["dtype"] == "bfloat16"]
    k2_bf16 = [r for r in kern["K2"] if r["dtype"] == "bfloat16"]
    def k2_call(recs, counts):
        out = per_call(recs, counts)
        out["library_ms"] = out["library_device_ms"] = None  # no one call
        names = {c.name: n for c, n in counts.items()}
        for k in ("sdpa_two_calls_ms", "sdpa_two_calls_device_ms"):
            out[k] = sum(names.get(r["case"], 0) * r[k] for r in recs)
        return out

    entries = []
    for name, source, replaces, wrapper, variant, recs, call in (
            ("fused_attention[tile]", "attention_tile.cu", ":55",
             "fused_attention", "tile",
             [r for r in bf16 if r["variant"] == "tile"], per_call),
            ("fused_attention[decode]", "attention_decode.cu", ":55",
             "fused_attention", "decode",
             [r for r in bf16 if r["variant"] == "decode"], per_call),
            ("fused_biattention[tile]", "attention_tile.cu", ":147",
             "fused_biattention", "tile", k2_bf16, k2_call)):
        paths = {}
        for path, (rec, counts) in runs.items():
            n = rec["launches_by_variant"][wrapper][variant]
            paths[path] = {"launches": n, **call(recs, counts)}
        sl = paths["predict"]
        entries.append({"name": name, "route": "cuda",
                        "source": f"gpv_tpu_torch/csrc/{source}",
                        "replaces": f"gpv_tpu/ops/attention.py{replaces}",
                        **sl, "per": f"one predict: B={B}, bf16, "
                        f"{runs['predict'][0]['decode_steps']} decode steps",
                        "paths": paths})
    return {"kernels": entries}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--report", type=Path, default=None,
                    help="also write every phase's record to this file")
    args = ap.parse_args()
    if not (ROOT / "gpv_tpu_torch" / "csrc").is_dir():
        fail("gpv_tpu_torch/ not found beside chip_smoke.py: run it from a "
             "checkout of the repository")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    sys.path.insert(0, str(ROOT))

    t_start = time.perf_counter()
    records = [phase_device()]
    emit(records[-1])
    for phase in (phase_build, phase_kernels):
        records.append(phase())
        emit(records[-1])
    kern = records[-1]
    with tempfile.TemporaryDirectory() as tmp:
        vocab_path = write_vocab(Path(tmp))
        t0 = time.perf_counter()
        eng = make_engine(vocab_path, "bfloat16", "cuda")
        sl, sl_counts, prof = phase_slice(eng, time.perf_counter() - t0)
        beam, beam_counts, prof_beam = phase_beam(eng)
        for rec in (sl, prof, beam, prof_beam, phase_e2e(vocab_path)):
            records.append(rec)
            emit(rec)
        checked = {r["case"] for r in kern["K1"] + kern["K2"]}
        serve, serve_counts = phase_serve(eng, checked)
        records.append(serve)
        emit(serve)
        ve, ve_counts = phase_vocab_embed(vocab_path)
        records.append(ve)
        emit(ve)
        ev, ev_counts = phase_eval(eng, vocab_path, Path(tmp), checked)
        records.append(ev)
        emit(ev)
        ex, ex_counts = phase_export(eng, vocab_path, Path(tmp), checked)
        records.append(ex)
        emit(ex)
        del eng
        tr, tr_counts, tr_eval, tr_eval_counts, batch, costs = phase_train(
            vocab_path, Path(tmp), checked)
        tr["two_phase"], tn = phase_train_native(vocab_path, Path(tmp), tr,
                                                 costs)
        for rec in (tr, tn):
            records.append(rec)
            emit(rec)
        records.append(phase_train_e2e(vocab_path, Path(tmp), batch))
        emit(records[-1])
    line = kernels_line(kern, {
        "predict": (sl, sl_counts), "predict_beam": (beam, beam_counts),
        "embed_vocab": (ve, ve_counts), "serve": (serve, serve_counts),
        "eval": (ev, ev_counts),
        "train_step": ({"launches_by_variant": by_variant(tr_counts)},
                       tr_counts),
        "train_eval": (tr_eval, tr_eval_counts),
        "export": (ex, ex_counts)})
    records.append(line)
    if args.report:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(
            {"records": records,
             "seconds": time.perf_counter() - t_start}, indent=1))
    emit(line)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
