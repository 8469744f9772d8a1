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
             (`torch.ops.gpv.*`, what exported programs call); `wide`, each
             case above Dh 128 in short (`vs_sdpa`: device us of the
             kernel, SDPA, plain and bound, x bound, x SDPA, and the
             cluster of CTAs it launched with);
  msdeform   the multi-scale deformable attention kernel
             (`ops.ms_deform_attn`) against its plain version in fp32 at
             GPV-1 on Deformable DETR's shapes (B=20, 4 levels of a 480x640
             image: S=6380 rows, 8 heads of 32, 4 points; the encoder's
             Q=S and the decoder's Q=300), bf16 and fp32, timed beside the
             plain version and through the op, with its bound; then a
             Deformable GPV's predict in each dtype
             (`gpvbench/configs/gpv1-deformable-r50.json`'s overrides),
             its launches by variant;
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
             equal, log-probs); then the card's fp32 engine (TF32 off) on
             the slice's batch: launches by variant (the fp32 tile and
             decode kernels) as path_launches gives them, images/s, and a
             profile (attention device ms by fp32 variant);
  wide_heads  the engine at model.detr.nheads=4 and
             model.co_att.bi_num_attention_heads=4 (the text decoder and
             co-attention at 4 heads of 192, DETR at 4 of 64), fp32 on the
             card and on the CPU on 2 images: predict and predict_beam
             (K=3) with launches by variant around each card call;
             boxes, relevance, first-step logits, greedy tokens and beam
             sequences and log-probs card against CPU at e2e's
             tolerances; then the card's bf16 engine's predict (launches
             by variant);
  bench      `python -m gpv_tpu_torch.bench` (the headline workload,
             bench.py's counterpart) as a fresh process for greedy and
             for mode=beam: each prints one JSON line with bench.py's
             keys and a positive images/s, printed here;
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
             batch, one step's host ms by span, the matcher's parts, one
             profiled step, peak memory, the in-train eval (40 samples a
             task), a save and a resume. Gates: every loss key finite,
             frozen parameters bit-unchanged and every other leaf moved,
             K1 12 launches a step at the dedup's rows, the eval's keys
             finite and its launches by variant, the restored state equal
             to the saved one, every shape a `kernels` case. Then an
             async round (`async`): a save with async_write, 2 steps
             while it writes, the join and a resume, which must restore
             the state at the save (model and AdamW bit for bit), and a
             second async save on the path (buffers reused): blocking
             ms, in-flight step s, join s. Then the
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
             gradients within 1e-3 x max(1, max|g|) per leaf;
  data_prep  offline data preparation on a seeded raw tree in COCO 2014 /
             VQA v2 schema (`write_raw_coco`: 1000 train2014 and 500
             val2014 images, cut from COCO's 82,783 / 40,504): the port's
             preprocess, SCE split (seed 0, train_frac 0.9) and stats CLIs
             in-process, seconds per stage, samples by task and subset
             kept and discarded, the vocab's size, the SCE assignment's
             samples/s. Gates: every count what the raw tree implies, the
             category split 40/10/30 with person shared, no train/val
             sample with an unseen category, train and val images
             disjoint, test from val2014, the vocab sorted with its four
             special tokens. Then `Trainer` on the prepared gpv_split and
             vocab.json (B=120, bf16, 8 forked workers,
             training.async_checkpoint, a `last` save after each of 2
             steps): losses finite, K1 launches as train_step_launches
             gives them at each batch's dedup rows, ckpts/last's model the
             trainer's at that save bit for bit; and `build_engine(ckpt=
             <exp>/ckpts/last)` predicting a B=20 val batch: launches as
             path_launches gives them, answers, boxes and relevance equal
             to the trainer's weights in memory (`GPVEngine.load_weights`);
  infer_dp   (after export) `tpu.infer_data_parallel=-1` on the one card
             builds the plain engine, bit-equal to it; an engine over
             cuda:0, cuda:0 against the one-device engine on a ragged
             batch of INFER_DP_N in fp32 (answers equal, boxes 1e-3), its
             bf16 launches by shard and images/s beside the engine's (a, b,
             b, a); export_engine refuses it;
  stem_s2d   `model.detr.stem_s2d`: fp32 predict against the plain stem
             (answers equal, boxes 2e-4, relevance 5e-4), bf16 images/s
             both ways (a, b, b, a), the stem's device ms both ways;
  ddp        (after train_e2e) (a) one NCCL rank through
             `initialize_distributed` and DDP, fp32 at global B=DDP_B,
             against the plain step (losses 1e-5 relative, parameters
             1e-5); (b) two gloo ranks on the one card, spawned as fresh
             processes of this script (`--rank-task step`), the same
             batch as 2 x DDP_B/2 against (a) (losses 1e-4 relative,
             gradients 1e-3 x max(1, max|g|), the assignment equal, the
             ranks' parameters bit-equal); (c) the same ranks timed at the
             global TRAIN_B in bf16 (step ms, images/s, the gloo
             all-reduce of the trainable gradients, peak memory a rank:
             two ranks on one card measure the mechanism, not 2-card
             scaling); (d) `cli.train` as two ranks (`--rank-task cli`):
             2 steps, rank 0's in-train eval and async `last` saves, then
             a relaunch that resumes `ckpts/last` on both ranks (the
             restored state is each rank's state at its last save, and
             the ranks agree); each rank has a RANK_TIMEOUT_S timeout;
  remat      B=TRAIN_B bf16 steps with `tpu.remat` off and on (peak memory,
             step ms); fp32 at REMAT_CHECK_B, dropout on, deterministic
             algorithms: every gradient with remat equal to no-remat's
             within 1e-5 of the leaf's largest.
  tp         (after remat) tensor parallelism over TP=2 ranks of a model
             group, spawned as fresh processes of this script (`--rank-task
             tp`, RANK_TIMEOUT_S each), gloo ranks sharing the one card:
             (a) fp32 (TF32 off), dropout 0, global B=DDP_B as (data 1,
             model 2) with the query dedup and as (data 2, model 2) on four
             ranks, against the plain one-process step from the same
             weights: losses 1e-4 relative, every gathered gradient 1e-3 x
             max(1, max|g|), the assignment equal, gathered parameters
             after AdamW 1e-5 where the plain gradient is determined (the
             tests' rule; the largest error anywhere is reported); the
             two steps differ by rounding, so an FFN unit whose ReLU input
             lies within it of 0 at some token can take the other side of
             the kink: the entries such a unit feeds (its linear1 row and
             bias, its linear2 column) are found from both steps' ReLU
             signs, left out of both gates and reported with their error,
             replicated leaves bit-equal across each model group and shards
             across data peers, launches by variant (K1 at 6 heads), and a
             bf16 step's launches; (b) the deterministic fp32 forward at
             B=TP_FWD_B (encode, teacher-forced answer logits, greedy) as
             (1, 2) against the unsharded model: boxes 2e-4, relevance
             logits 5e-4, answer logits and the first greedy step's 2e-3,
             the ranks' outputs equal, launches by variant in fp32 and
             bf16 (K1 at 4 / 6 / 4 heads, K2 at 8); (c) TP_TIMED_STEPS
             bf16 steps at the global TRAIN_B with dedup as (1, 2): a
             rank's step ms, combined images/s, peak memory, the model
             group's all-reduces a step with their bytes and (one more
             step, synchronised at each) ms, and the device ms of a step's
             sharded dropout draws whole against a rank's share, beside
             remat's one-process plain step (two ranks on one card measure
             the mechanism, not 2-card scaling); (d) `cli.train` with
             tpu.mesh.model=TP as two ranks (2 steps, rank 0's in-train
             eval on the gathered weights, async `last` saves), then in
             the same ranks a second launch that resumes the `train`
             phase's one-process checkpoint (its gathered state is that
             file's, bit for bit), and here a one-process `Trainer` that
             resumes the TP run's `ckpts/last` (its state is the gathered
             TP state at the save, bit for bit).
Then a `total` line (the whole script's seconds) and one `kernels` line
(each kernel of the paths, the deformable sampling's per Deformable
predict: launches and per-call
ms, device ms, bound in the measured predict, and the same for
predict_beam, embed_vocab, the whole serve run, the whole eval phase, one
train step, the in-train eval, the exported bundle's B=20 predict,
data_prep's two train steps and its predict, and tp's bf16 step (a), bf16
forward (b), timed steps (c) and cli.train rank 0's steps (d) under
`paths`), and
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
import os
import re
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
DEVICE = "cuda"  # the card; the ranks a phase spawns take theirs from it
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
# dense peaks: bf16 runs on the tensor cores; the fp32 kernels run with
# TF32 off (the route holds the plain fp32 version to 1e-5), as fp32 FMAs
# on the CUDA cores, whose peak is 67 TFLOP/s, not TF32's 495
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # x max(1, |plain| max)
B, IMG_H, IMG_W, QUERY_TOKENS, VOCAB = 20, 480, 640, 12, 10000
# GPV-1 on Deformable DETR (gpvbench/configs/gpv1-deformable-r50.json):
# the levels of a 480x640 image, heads, head dim, points, queries, layers
DEFORM_OVERRIDES = ("model.detector=deformable_detr",
                    "model.detr.num_queries=300",
                    "model.detr.dim_feedforward=1024")
DEFORM_LEVELS = ((60, 80), (30, 40), (15, 20), (8, 10))
DEFORM_H, DEFORM_DH, DEFORM_P, DEFORM_Q, DEFORM_LAYERS = 8, 32, 4, 300, 6
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
# every U the dedup emits at TRAIN_B: multiples of its bucket (16), capped
DEDUP_ROWS = tuple(range(16, TRAIN_B, 16)) + (TRAIN_B,)
E2E_TRAIN_B = 4
# data parallelism: the fp32 check's global batch, timed bf16 steps, a
# rank's hard timeout, and cli.train's samples a task (2 global batches)
DDP_B, DDP_TIMED_STEPS, RANK_TIMEOUT_S = 24, 5, 600
DDP_CLI_SAMPLES, DDP_CLI_VAL = 60, 20
REMAT_STEPS, REMAT_CHECK_B = 3, 8
# head dims other configs give. `wide_heads` builds the engine at
# WIDE_OVERRIDES on WIDE_B images; WIDE_HEADS are the (heads, Dh) of the
# 768-wide text decoder at 4, 3, 2 and 1 heads, timed as `kernels` cases
# with K2 at WIDE_K2_HEADS heads (Dh 768 / heads)
WIDE_OVERRIDES = ("model.detr.nheads=4",
                  "model.co_att.bi_num_attention_heads=4")
WIDE_B = 2
WIDE_HEADS = ((4, 192), (3, 256), (2, 384), (1, 768))
WIDE_K2_HEADS = (64, 4, 3, 2, 1)
BENCH_TIMEOUT_S = 300  # one `gpv_tpu_torch.bench` process
# tensor parallelism: the model axis, the forward check's batch and the
# timed bf16 steps at the released global batch
TP, TP_FWD_B, TP_TIMED_STEPS = 2, 4, 5
INFER_DP_N = 23  # a ragged batch over two shards (12 + 11, padded to 24)
STEM_REPS = 20
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

    @property
    def fp32_variant(self) -> str:
        """The kernel an fp32 call takes, as the wrapper plans it."""
        import torch
        from gpv_tpu_torch.ops.attention import _plan
        return _plan(torch.float32, self.tq, self.tk, self.dh,
                     both=self.k2).variant


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
    and predict_beam at B, embed_vocab, both paths at each serving bucket,
    a train step at every row count the query dedup can emit (the
    prepared data's batches take any of them) and at each batch a rank or
    a check takes whole (ddp, remat), the multi-device engine's shards;
    then the teacher-forced causal shape (training's, on no path here)."""
    calls = [path_launches("predict", 0), path_launches("predict_beam", 0),
             path_launches("embed_vocab", 0)]
    for b in SERVE_BUCKETS:
        calls += [path_launches("predict", 0, b),
                  path_launches("predict_beam", 0, b, SERVE_BEAM)]
    calls += [train_step_launches(rows, True) for rows in DEDUP_ROWS]
    calls += [train_step_launches(rows, False) for rows in (
        TRAIN_B, E2E_TRAIN_B, DDP_B, DDP_B // 2, TRAIN_B // 2,
        REMAT_CHECK_B)]
    # tensor parallelism (`tp`): a rank's heads at TP ranks, the dedup's
    # rows at the check's batch and the released one, the (2, 2) ranks' and
    # cli.train's undeduplicated rows, and the B=4 forward
    calls += [tp_step_launches(rows, True) for rows in
              dict.fromkeys((16, DDP_B) + DEDUP_ROWS)]
    calls += [tp_step_launches(DDP_B // 2, False),
              tp_step_launches(TRAIN_B, False), tp_forward_launches()]
    # the multi-device engine's shards: fp32 INFER_DP_N over two, bf16 B
    calls += [path_launches("predict", 0, -(-INFER_DP_N // 2)),
              path_launches("predict", 0, B // 2)]
    # the engine at WIDE_OVERRIDES (`wide_heads`), greedy and beam
    calls += [wide_launches("predict", 0), wide_launches("predict_beam", 0)]
    return list(dict.fromkeys(c for counts in calls for c in counts)) + [
        Case("teacher_forced_causal", B, 20, 20, 8, 96, None, True)] + \
        wide_cases()


def wide_launches(path: str, steps: int, batch: int = WIDE_B,
                  beam: int = E2E_BEAM) -> Counter:
    """{Case: launches} of one call of `path` ("predict", or
    "predict_beam" with `beam` beams) on `batch` samples by the engine at
    WIDE_OVERRIDES: DETR at 4 heads of 64, BERT as released, K2 and the
    text decoder at 4 heads of 192."""
    s = f"_wide_b{batch}"
    out = Counter({
        Case("detr_encoder_self" + s, batch, 300, 300, 4, 64, None): 6,
        Case("detr_decoder_self" + s, batch, 100, 100, 4, 64, None): 6,
        Case("detr_decoder_cross" + s, batch, 100, 300, 4, 64, None): 6,
        Case("bert_self" + s, batch, 20, 20, 12, 64, "query"): 12,
        Case("masks_10" + s, batch, 100, 20, 4, 192, "query"): 3})
    if path == "predict":
        step, rows, tq = "decode_step", batch, 1
    else:
        step, rows, tq = f"beam{beam}_step", batch * beam, beam
    out[Case(f"{step}_self{s}", rows, 1, 20, 4, 192, "cache")] = 3 * steps
    out[Case(f"{step}_cross{s}", batch, tq, 120, 4, 192, "memory")] = \
        3 * steps
    return out


def wide_cases() -> list:
    """The text decoder's step and teacher-forced shapes at B with each of
    WIDE_HEADS, and K2 (masks_10's streams) at each of WIDE_K2_HEADS:
    every head dim a config of the 768-wide streams gives, 12 to 768; and
    the teacher-forced cross-attention of a 1024-wide text decoder at one
    head (a cluster of 8 CTAs; no fp32 launch took Dh 805 to 2048 before
    the clusters)."""
    out = [Case("teacher_forced_cross_dh1024", B, 20, 120, 1, 1024,
                "memory")]
    for h, dh in WIDE_HEADS:
        s = f"_h{h}"
        out += [Case("decode_step_self" + s, B, 1, 20, h, dh, "cache"),
                Case("decode_step_cross" + s, B, 1, 120, h, dh, "memory"),
                Case("teacher_forced_causal" + s, B, 20, 20, h, dh, None,
                     True),
                Case("teacher_forced_cross" + s, B, 20, 120, h, dh,
                     "memory")]
    return out + [Case(f"masks_10_h{h}", B, 100, 20, h, 768 // h, "query")
                  for h in WIDE_K2_HEADS]


def train_step_launches(rows: int, dedup: bool) -> Counter:
    """{Case: launches} of one train step: frozen BERT on K1 alone (12
    layers) at `rows` query rows (the dedup's U unique rows, or the whole
    batch); DETR, co-attention and the text decoder take the training
    attention and launch nothing."""
    name = (f"bert_self_train_u{rows}" if dedup
            else "bert_self_train" + ("" if rows == TRAIN_B else f"_b{rows}"))
    return Counter({Case(name, rows, 20, 20, 12, 64, "query"): 12})


def tp_step_launches(rows: int, dedup: bool) -> Counter:
    """`train_step_launches` of one rank of a model group of TP: frozen
    BERT's K1 at its 12 / TP heads."""
    name = f"bert_self_train_tp{TP}_{'u' if dedup else 'b'}{rows}"
    return Counter({Case(name, rows, 20, 20, 12 // TP, 64, "query"): 12})


def tp_forward_launches(batch: int = TP_FWD_B, steps: int = 19) -> Counter:
    """{Case: launches} of one rank's deterministic forward under TP on
    `batch` samples: DETR, BERT and co-attention at their heads / TP, the
    teacher-forced text decoder (causal self-attention, cross-attention
    over the memory) and `steps` greedy steps at 8 / TP heads."""
    s, h = f"_tp{TP}_b{batch}", 8 // TP
    return Counter({
        Case("detr_encoder_self" + s, batch, 300, 300, h, 32, None): 6,
        Case("detr_decoder_self" + s, batch, 100, 100, h, 32, None): 6,
        Case("detr_decoder_cross" + s, batch, 100, 300, h, 32, None): 6,
        Case("bert_self" + s, batch, 20, 20, 12 // TP, 64, "query"): 12,
        Case("masks_10" + s, batch, 100, 20, 16 // TP, 48, "query"): 3,
        Case("teacher_forced_causal" + s, batch, 20, 20, h, 96, None,
             True): 3,
        Case("teacher_forced_cross" + s, batch, 20, 120, h, 96,
             "memory"): 3,
        Case("decode_step_self" + s, batch, 1, 20, h, 96, "cache"):
            3 * steps,
        Case("decode_step_cross" + s, batch, 1, 120, h, 96, "memory"):
            3 * steps})


def k1_cases() -> list:
    return [c for c in path_cases() if not c.k2]


def by_variant(counts: Counter, dtype: str = "bfloat16") -> dict:
    """{Case: launches} -> launches by wrapper and kernel variant, in the
    form the wrappers count them, for a run in `dtype` (bf16 calls take
    the tile and decode kernels, fp32 calls the variant `_plan` gives)."""
    out = {"fused_attention": {"tile": 0, "decode": 0, "fp32_tile": 0,
                               "fp32_decode": 0},
           "fused_biattention": {"tile": 0, "fp32_tile": 0}}
    for c, n in counts.items():
        variant = c.variant if dtype == "bfloat16" else c.fp32_variant
        out["fused_biattention" if c.k2 else "fused_attention"][variant] \
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
    peak the kernels of that type run at (PEAK_FLOPS). The larger one
    bounds."""
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
                       (False, True)) if c.name == "masks_10"
                      else ((True, False),))
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
                plan = A._plan(dtype, tq, tk, dh)
                rec = {"case": name, "dtype": dname,
                       "shape": [b, tq, tk, h, dh],
                       "variant": plan.variant, "cluster": plan.cluster,
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
                plan = A._plan(dtype, t2, t1, dh, both=True)
                rec = {"case": f"masks_{int(has1)}{int(has2)}"
                       + c.name[len("masks_10"):], "dtype": dname,
                       "shape": [b, t2, t1, h, dh],
                       "variant": plan.variant, "cluster": plan.cluster,
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
    return {"phase": "kernels", "K1": k1, "K2": k2,
            "wide": [vs_sdpa(r) for r in k1 + k2 if r["shape"][-1] > 128]}


def _msdeform_inputs(q: int, dtype, g):
    """Random inputs of one deformable layer's sampling at B: (value, off,
    logits) in `dtype`, ref fp32."""
    import torch
    S, L = sum(h * w for h, w in DEFORM_LEVELS), len(DEFORM_LEVELS)
    dev = torch.device("cuda")
    value = torch.randn(B, S, DEFORM_H, DEFORM_DH, device=dev, generator=g)
    ref = torch.rand(B, q, L, 2, device=dev, generator=g)
    off = torch.randn(B, q, DEFORM_H, L, DEFORM_P, 2, device=dev,
                      generator=g)
    logits = torch.randn(B, q, DEFORM_H, L * DEFORM_P, device=dev,
                         generator=g)
    return [t.to(dtype) for t in (value, off, logits)], ref


def _deform_predict(vocab_path: Path, dtype: str) -> dict:
    """One Deformable GPV predict at B in `dtype` after a warm one: its
    wall ms, its kernel launches by variant, its boxes checked."""
    import torch
    from gpv_tpu_torch.ops.ms_deform_attn import ms_deform_attn
    eng = make_engine(vocab_path, dtype, "cuda", DEFORM_OVERRIDES)
    images, queries = _batch(7, B)
    eng.predict(images, queries)
    torch.cuda.synchronize()
    before = dict(ms_deform_attn.variant_launches)
    t = time.perf_counter()
    rows = eng.predict(images, queries)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t)
    launches = {v: n - before[v]
                for v, n in ms_deform_attn.variant_launches.items()}
    _check_boxes(rows, DEFORM_Q)
    want = {v: 0 for v in launches}
    want["bf16" if dtype == "bfloat16" else "fp32"] = 2 * DEFORM_LAYERS
    if launches != want:
        fail(f"msdeform predict ({dtype}): launches {launches}, expected "
             f"{want} (one a deformable layer)")
    del eng
    torch.cuda.empty_cache()
    return {"ms": ms, "launches_by_variant": {"ms_deform_attn": launches}}


def phase_msdeform(vocab_path: Path) -> dict:
    """The deformable sampling kernel against `ms_deform_attn_plain` in
    fp32 on the same (rounded) inputs, at the tolerances of
    tests/test_torch_port_msdeform_card.py: 1e-4 of the largest value (the
    locations rounded another way), plus 2^-8 of the largest output in
    bf16 (the output's rounding). Timed beside the plain version and
    through the op; the bound is the operation's own bytes (value,
    offsets, logits, reference points read once, the output written
    once) at the card's memory rate, or its multiply-adds (4 corners of 2
    and the weighting, a sample and channel) at the peak; each case keeps
    its launch's plan (`_plan`: tile, threads, shared memory, blocks).
    Then a Deformable predict in each dtype (`_deform_predict`)."""
    import torch
    from gpv_tpu_torch.ops.ms_deform_attn import (_plan, ms_deform_attn,
                                                  ms_deform_attn_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    shapes = [tuple(hw) for hw in DEFORM_LEVELS]
    flat = [x for hw in shapes for x in hw]
    S = sum(h * w for h, w in shapes)
    cases = []
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            for name, q in (("encoder", S), ("decoder", DEFORM_Q)):
                (value, off, logits), ref = _msdeform_inputs(q, dtype, g)
                got = ms_deform_attn(value, shapes, ref, off, logits)
                want = ms_deform_attn_plain(value.float(), shapes, ref,
                                            off.float(), logits.float())
                torch.cuda.synchronize()
                err = (got.float() - want).abs().max().item()
                tol = 1e-4 * value.float().abs().max().item()
                if dtype == torch.bfloat16:
                    tol += 2.0 ** -8 * want.abs().max().item()
                if not err <= tol:
                    fail(f"msdeform {name} {dname}: max abs err {err} > "
                         f"{tol}")
                calls = {
                    "": lambda: ms_deform_attn(value, shapes, ref, off,
                                               logits),
                    "plain_": lambda: ms_deform_attn_plain(
                        value, shapes, ref, off, logits)}
                rec = {"case": name, "dtype": dname,
                       "shape": [B, S, q, DEFORM_H, DEFORM_DH,
                                 len(shapes), DEFORM_P],
                       "variant": "bf16" if dtype == torch.bfloat16
                       else "fp32",
                       "plan": _plan(B, q, S, DEFORM_H, len(shapes),
                                     DEFORM_P, dtype)._asdict(),
                       "max_abs_err": err, "tol": tol,
                       **_timings(calls),
                       "op_ms": time_ms(lambda: torch.ops.gpv.ms_deform_attn(
                           value, flat, ref, off, logits))}
                nbytes = (value.numel() + off.numel() + logits.numel()
                          + got.numel()) * value.element_size() \
                    + ref.numel() * ref.element_size()
                samples = B * q * DEFORM_H * len(shapes) * DEFORM_P
                rec.update(_bound(nbytes, samples * DEFORM_DH * (4 * 2 + 2),
                                  dname))
                cases.append(rec)
                del value, off, logits, ref, got, want
                torch.cuda.empty_cache()
    predict = {dtype: _deform_predict(vocab_path, dtype)
               for dtype in ("bfloat16", "float32")}
    return {"phase": "msdeform", "cases": cases, "predict": predict}


def msdeform_entries(rec: dict) -> list:
    """The `kernels` line's entries of the deformable sampling kernel, one
    a route: one Deformable predict's launches (measured) and its device
    ms and bound (each layer's case times its layers: 6 encoder and 6
    decoder)."""
    keys = ("ms", "device_ms", "plain_ms", "plain_device_ms", "op_ms",
            "bound_ms", "bytes_ms", "ops_ms")
    out = []
    for dname, variant in (("bfloat16", "bf16"), ("float32", "fp32")):
        recs = [r for r in rec["cases"] if r["dtype"] == dname]
        tot = {k: DEFORM_LAYERS * sum(r[k] for r in recs) for k in keys}
        tot["bound_by"] = ("bytes" if tot.pop("bytes_ms")
                           >= tot.pop("ops_ms") else "operations")
        run = rec["predict"][dname]
        out.append({
            "name": f"ms_deform_attn[{variant}]", "route": "cuda",
            "source": "gpv_tpu_torch/csrc/ms_deform_attn.cu",
            "replaces": None,  # the JAX package has no deformable attention
            "launches": run["launches_by_variant"]["ms_deform_attn"][
                variant], **tot,
            "library_ms": None, "library_device_ms": None,  # none offered
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "predict_ms": run["ms"],
            "per": f"one Deformable predict: B={B}, {variant}, "
                   f"{DEFORM_LAYERS} encoder and {DEFORM_LAYERS} decoder "
                   "layers"})
    return out


def vs_sdpa(rec: dict) -> dict:
    """One `kernels` case in short: device us a launch of the kernel, SDPA
    (K2: its two calls) and the plain version, the bound, the kernel's
    time over the bound and over SDPA, and the cluster it launched with
    (0: none, Dh <= 128)."""
    sdpa = rec.get("library_device_ms") or rec["sdpa_two_calls_device_ms"]
    us = {k: round(1e3 * rec[f], 2) for k, f in (
        ("device_us", "device_ms"), ("plain_us", "plain_device_ms"),
        ("bound_us", "bound_ms"))}
    return {"case": rec["case"], "dtype": rec["dtype"],
            "shape": rec["shape"], "variant": rec["variant"],
            "cluster": rec["cluster"], **us, "sdpa_us": round(1e3 * sdpa, 2),
            "x_bound": round(rec["device_ms"] / rec["bound_ms"], 2),
            "x_sdpa": round(rec["device_ms"] / sdpa, 3)}


def _queries(n: int, rng):
    """Queries of exactly QUERY_TOKENS WordPiece tokens under the debug
    tokenizer (one piece per letter, plus [CLS] and [SEP])."""
    letters = "abcdefghijklmnopqrstuvwxyz"
    out = []
    for _ in range(n):
        word = "".join(rng.choice(list(letters), QUERY_TOKENS - 6))
        out.append(f"what {word}")
    return out


# the port's kernels by the name each __global__ function has in a trace:
# (key, name fragment, wrapper, variant)
PORT_KERNELS = (
    ("K2 tile", "gpv_attn_tile_bi_kernel", "fused_biattention", "tile"),
    ("K1 tile", "gpv_attn_tile_kernel", "fused_attention", "tile"),
    ("K1 decode", "gpv_attn_decode_kernel", "fused_attention", "decode"),
    ("K2 fp32 tile", "gpv_attn_fp32_bi_kernel", "fused_biattention",
     "fp32_tile"),
    ("K1 fp32 tile", "gpv_attn_fp32_tile_kernel", "fused_attention",
     "fp32_tile"),
    ("K1 fp32 decode", "gpv_attn_fp32_decode_kernel", "fused_attention",
     "fp32_decode"))


def phase_profile(phase: str, call, counts: Counter,
                  dtype: str = "bfloat16") -> dict:
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

    # device activity alone: the record reads only device events, and
    # aggregating a CPU trace of a forked-loader run took about 10 s a call
    acts = [ProfilerActivity.CUDA]
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
        _check_counts(phase, wrappers, want, dtype)
        rec = _profile_record(phase, prof, wall_ms, want, dtype)
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


def _profile_record(phase: str, prof, wall_ms: float, counts,
                    dtype: str = "bfloat16") -> dict:
    rows = sorted(_device_events(prof), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    groups = (("port_attention_kernels", ("gpv_attn_",)),
              ("conv", ("conv", "cudnn", "fprop", "implicit")),
              ("gemm", ("gemm", "nvjet", "cutlass", "xmma")),
              ("memcpy", ("memcpy",)))
    by_group = {g: 0.0 for g, _ in groups}
    by_group["other"] = 0.0
    port = {key: {"launches": 0, "device_ms": 0.0}
            for key, *_ in PORT_KERNELS}
    for ms, n, name in rows:
        low = name.lower()
        group = next((g for g, words in groups
                      if any(w in low for w in words)), "other")
        by_group[group] += ms
        key = next((k for k, frag, *_ in PORT_KERNELS if frag in name),
                   None)
        if key is not None:
            port[key]["launches"] += n
            port[key]["device_ms"] += ms
    got = {k: v["launches"] for k, v in port.items()}
    v = by_variant(counts, dtype)
    want = {key: v[wrapper][variant]
            for key, _, wrapper, variant in PORT_KERNELS}
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


def _check_counts(phase: str, got: dict, counts: Counter,
                  dtype: str = "bfloat16") -> None:
    """Fails unless the wrappers' counts by variant (`_read_counts`) are
    what `counts` ({Case: launches}) gives for a run in `dtype`."""
    want = by_variant(counts, dtype)
    if got != want:
        fail(f"{phase}: launches by variant {got} != expected {want}")


def write_vocab(directory: Path) -> Path:
    """A generated VOCAB-word answer vocabulary (`vocab.json`)."""
    from gpv_tpu_torch.text.vocab import AnswerVocab
    path = directory / "vocab.json"
    path.write_text(json.dumps(AnswerVocab.debug(size=VOCAB).words))
    return path


def make_engine(vocab_path: Path, dtype: str, device: str,
                overrides=()):
    """The engine of `configs/exp/gpv_inference.yaml` at the released
    widths (and `overrides`), seeded random weights (ckpt=null), through
    the entry point."""
    from gpv_tpu_torch.infer.build import build_engine
    from gpv_tpu_torch.utils.config import load_config
    return build_engine(load_config(
        ROOT / "configs", "exp/gpv_inference",
        ["ckpt=null", f"tpu.dtype={dtype}", f"model.vocab={vocab_path}",
         f"device={device}", *overrides]))


def _check_boxes(rows, n: int = 100) -> None:
    for r in rows:
        boxes, rel = r["boxes"], r["relevance"]
        if boxes.shape != (n, 4) or rel.shape != (n,):
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


def phase_e2e(vocab_path: Path):
    """fp32 card against CPU, then the card's fp32 engine timed
    (`_fp32_predict`). Returns the record and the timed predict's
    {Case: launches}."""
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
        if device == "cuda":
            timed, counts = _fp32_predict(eng)
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
    rec["fp32_predict"] = timed
    return rec, counts


def _fp32_predict(eng):
    """`predict` of the fp32 engine (TF32 off) on the slice's batch:
    launches by variant around one call against `path_launches`, images/s,
    and a profile of one more call (the fp32 kernels' device ms by
    variant, idle share). Returns the record and {Case: launches}."""
    import torch

    images, queries = _batch(0, B)
    eng.predict(images, queries)  # warm-up (cuDNN plans, allocator)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    results = eng.predict(images, queries)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    launches, var = _read_counts()
    steps = eng.last_decode_steps
    counts = path_launches("predict", steps)
    _check_counts("e2e fp32 predict", var, counts, "float32")
    if len(results) != B:
        fail(f"e2e fp32 predict: {len(results)} results for {B} images")
    _check_boxes(results)
    prof = phase_profile("e2e fp32 profile",
                         lambda: eng.predict(images, queries), counts,
                         "float32")
    fp32 = {k: v for k, v in prof["port_kernels"].items() if "fp32" in k}
    return {"batch": B, "dtype": "float32", "decode_steps": steps,
            "launches": launches, "launches_by_variant": var,
            "measured_call_s": call_s,
            "images_per_s": _images_per_s(
                lambda: eng.predict(images, queries), 3),
            "attention_by_variant": fp32,
            "attention_device_ms": sum(v["device_ms"] for v in fp32.values()),
            "profile": {k: prof[k] for k in (
                "wall_ms", "device_busy_ms", "device_idle_share",
                "ms_by_group", "profiled_launches", "expected_launches")}}, \
        counts


def phase_wide_heads(vocab_path: Path, checked: set):
    """Wide heads end to end: the engine at WIDE_OVERRIDES in fp32 (TF32
    off) on the card and on the CPU, on WIDE_B images. Returns the record, the
    card's fp32 runs {path: (record, {Case: launches})} and its bf16
    predict's run."""
    import torch
    from gpv_tpu_torch.decode.greedy import greedy_decode
    from gpv_tpu_torch.ops.image import normalize_image

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    rng = np.random.RandomState(2)
    images = rng.randint(0, 256, (WIDE_B, IMG_H, IMG_W, 3)).astype(np.uint8)
    queries = _queries(WIDE_B, rng)
    rec = {"phase": "wide_heads", "overrides": list(WIDE_OVERRIDES),
           "images": WIDE_B, "beam_size": E2E_BEAM}
    outs, runs = {}, {}

    def gated(name, path, eng, call, dtype):
        _reset_counts()
        result = call()
        torch.cuda.synchronize()
        _, var = _read_counts()
        steps = eng.last_decode_steps
        counts = wide_launches(path, steps)
        _check_counts(f"wide_heads {name}", var, counts, dtype)
        missing = {c.name for c in counts} - checked
        if missing:
            fail(f"wide_heads {name}: shapes not among the kernels cases: "
                 f"{sorted(missing)}")
        return result, ({"launches_by_variant": var, "decode_steps": steps},
                        counts)

    for device in ("cuda", "cpu"):
        eng = make_engine(vocab_path, "float32", device, WIDE_OVERRIDES)
        heads = {"text_decoder": eng.model.text_decoder.layers[0]
                 .self_attn.num_heads,
                 "co_att": eng.model.co_att_transformer[0].biattention
                 .num_heads}
        if heads != {"text_decoder": 4, "co_att": 4}:
            fail(f"wide_heads: heads {heads}, expected 4 and 4")
        predict = lambda: eng.predict(images, queries)  # noqa: E731
        beam = lambda: eng.predict_beam(  # noqa: E731
            images, queries, beam_size=E2E_BEAM)
        if device == "cuda":
            res, runs["wide_heads_predict"] = gated(
                "predict", "predict", eng, predict, "float32")
            bres, runs["wide_heads_beam"] = gated(
                "predict_beam", "predict_beam", eng, beam, "float32")
        else:
            res, bres = predict(), beam()
        _check_boxes(res)
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
        outs[device] = {
            "boxes": out["pred_boxes"].float().cpu(),
            "relevance": out["pred_relevance_logits"].float().softmax(-1)
            [..., 0].cpu(),
            "logits0": logits[:, 0].cpu(), "tokens": tokens.cpu(),
            "answers": [r["answer"] for r in res],
            "beam_answers": [r["answers"] for r in bres],
            "beam_probs": torch.tensor(np.asarray(
                [r["answer_probs"] for r in bres], np.float32))}
        del eng
    c, p = outs["cuda"], outs["cpu"]
    for key, tol in (("boxes", 1e-3), ("relevance", 1e-3),
                     ("logits0", 2e-3), ("beam_probs", 2e-3)):
        err = (c[key] - p[key]).abs().max().item()
        rec[f"{key}_max_abs_err"], rec[f"{key}_tol"] = err, tol
        if not err <= tol:
            fail(f"wide_heads {key}: max abs err {err} > {tol}")
    for key in ("tokens", "answers", "beam_answers"):
        same = (torch.equal(c[key], p[key]) if key == "tokens"
                else c[key] == p[key])
        if not same:
            fail(f"wide_heads {key} differ: card {c[key]} cpu {p[key]}")
    rec["tokens_equal"] = rec["answers_equal"] = True
    rec["launches_by_variant"] = {
        k: v[0]["launches_by_variant"] for k, v in runs.items()}

    # the bf16 engine on the card: the tile and decode kernels at Dh 192
    eng = make_engine(vocab_path, "bfloat16", "cuda", WIDE_OVERRIDES)
    res, bf16_run = gated("bf16 predict", "predict", eng,
                          lambda: eng.predict(images, queries), "bfloat16")
    _check_boxes(res)
    rec["bf16_launches_by_variant"] = bf16_run[0]["launches_by_variant"]
    del eng
    rec["seconds"] = time.perf_counter() - t_phase
    return rec, runs, bf16_run


BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "baseline_estimated",
              "device", "power_limit_w"}


def phase_bench() -> dict:
    """`python -m gpv_tpu_torch.bench`, greedy and `mode=beam`, each a
    fresh process on the card as a user runs it: one JSON line each with
    bench.py's keys and a positive images/s, printed as it came."""
    rec = {"phase": "bench"}
    for name, args in (("greedy", []), ("beam", ["mode=beam"])):
        t0 = time.perf_counter()
        try:
            run = subprocess.run(
                [sys.executable, "-m", "gpv_tpu_torch.bench", *args],
                cwd=ROOT, capture_output=True, text=True,
                timeout=BENCH_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            fail(f"bench {name}: no line within {BENCH_TIMEOUT_S} s")
        lines = [ln for ln in run.stdout.splitlines() if ln.strip()]
        if run.returncode != 0 or len(lines) != 1:
            fail(f"bench {name}: exit {run.returncode}, {len(lines)} lines; "
                 f"stderr {run.stderr[-2000:]}")
        print(lines[0], flush=True)
        try:
            line = json.loads(lines[0])
        except json.JSONDecodeError:
            fail(f"bench {name}: not one JSON line: {lines[0]!r}")
        if set(line) != BENCH_KEYS or not line["value"] > 0:
            fail(f"bench {name}: keys {sorted(line)} value "
                 f"{line.get('value')}")
        want = ("batched_inference_images_per_sec" if name == "greedy"
                else "batched_beam5_inference_images_per_sec")
        if line["metric"] != want:
            fail(f"bench {name}: metric {line['metric']} != {want}")
        rec[name] = {**line, "seconds": time.perf_counter() - t0}
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


# COCO 2014's 80 categories in the order of their ids (COCO_IDS)
COCO_NAMES = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush")
COCO_IDS = (list(range(1, 12)) + list(range(13, 26)) + [27, 28]
            + list(range(31, 45)) + list(range(46, 66)) + [67, 70]
            + list(range(72, 83)) + list(range(84, 91)))
# the raw tree of data_prep: COCO 2014 cut from 82,783 / 40,504 images
RAW_TRAIN_IMAGES, RAW_VAL_IMAGES = 1000, 500
RAW_FILLER = ("a", "the", "is", "on", "in", "with", "near", "next", "to",
              "sitting", "standing", "white", "red", "large", "small",
              "some", "there", "field", "street", "room", "picture")
RAW_COLORS = ("red", "white", "black", "blue", "green", "orange", "brown")
# captions and answers that reach the special cases of the SCE split
RAW_SPECIAL = ("a man eating a hot dog at a table",
               "a teddy bear sitting on a bed",
               "an orange cat lying on a couch",
               "people watch the game on tv",
               "a man wearing a gold watch",
               "two oranges in a bowl",
               "a wine glass next to a cup")


def write_raw_coco(data_dir: Path, n_train: int = RAW_TRAIN_IMAGES,
                   n_val: int = RAW_VAL_IMAGES, seed: int = 0) -> dict:
    """A seeded raw tree in COCO 2014 / VQA v2 schema under `data_dir`, in
    the layout of `configs/data/preprocess_*.yaml`: instances (the 80
    categories under their COCO ids, about 7.3 boxes an image over about
    2.9 categories), 5 captions an image, and about 5.4 VQA questions an
    image with 10 answers each, for `n_train` train2014 and `n_val` val2014
    images. The text mixes category synonyms (hot dog, teddy bear, orange
    as a colour, watch as a verb) with filler words. Returns, per image id,
    its subset and its (image, category) pairs, captions and questions."""
    from gpv_tpu_torch.evaluation.vocab_mask import coco_synonyms
    syn = coco_synonyms()
    if set(syn) != set(COCO_NAMES):
        fail("the synonym table's keys are not COCO's 80 categories")
    rng = np.random.RandomState(seed)
    ann_dir = data_dir / "learning_phase_data/coco/annotations"
    vqa_dir = data_dir / "learning_phase_data/vqa"
    for d in (ann_dir, vqa_dir / "questions", vqa_dir / "anno"):
        d.mkdir(parents=True, exist_ok=True)
    cats = [{"id": i, "name": n, "supercategory": "thing"}
            for i, n in zip(COCO_IDS, COCO_NAMES)]
    weight = np.where(np.asarray(COCO_NAMES) == "person", 10.0, 1.0)
    ids = rng.choice(np.arange(1, 600000), n_train + n_val, replace=False)
    truth, ann_id, cap_id = {}, 1, 1

    def phrase(names):
        return str(rng.choice(syn[names[rng.randint(len(names))]]))

    for subset, image_ids in (("train2014", ids[:n_train]),
                              ("val2014", ids[n_train:])):
        images, annos, caps, qs, qannos = [], [], [], [], []
        for image_id in map(int, image_ids):
            h, w = COCO_SIZES[image_id % len(COCO_SIZES)]
            images.append({"id": image_id, "height": h, "width": w,
                           "file_name": f"COCO_{subset}_{image_id:012d}.jpg"})
            k = min(1 + rng.poisson(1.9), 8)
            names = [COCO_NAMES[i] for i in rng.choice(
                80, k, replace=False, p=weight / weight.sum())]
            for name in names:
                for _ in range(1 + rng.poisson(1.5)):
                    x, y = rng.uniform(0, 0.8 * w), rng.uniform(0, 0.8 * h)
                    annos.append({
                        "id": ann_id, "image_id": image_id, "iscrowd": 0,
                        "category_id": COCO_IDS[COCO_NAMES.index(name)],
                        "bbox": [round(x, 2), round(y, 2),
                                 round(rng.uniform(4, w - x), 2),
                                 round(rng.uniform(4, h - y), 2)]})
                    ann_id += 1
            for _ in range(5):
                if rng.rand() < 0.15:
                    text = str(rng.choice(RAW_SPECIAL))
                else:
                    text = " ".join([str(rng.choice(RAW_FILLER)),
                                     phrase(names),
                                     str(rng.choice(RAW_FILLER)),
                                     str(rng.choice(RAW_FILLER)),
                                     phrase(names)])
                caps.append({"id": cap_id, "image_id": image_id,
                             "caption": text.capitalize() + "."})
                cap_id += 1
            n_q = 5 + int(rng.rand() < 0.4)
            for q in range(n_q):
                kind = rng.randint(6)
                noun = phrase(names)
                if kind == 0:
                    text, ans, atype = (f"what color is the {noun}?",
                                        str(rng.choice(RAW_COLORS)), "other")
                elif kind == 1:
                    text, ans, atype = (f"how many {noun} are there?",
                                        str(rng.randint(1, 6)), "number")
                elif kind == 2:
                    text, ans, atype = (f"is there a {noun} in the picture?",
                                        str(rng.choice(("yes", "no"))),
                                        "yes/no")
                elif kind == 3:
                    text, ans, atype = ("what is the man holding?", noun,
                                        "other")
                elif kind == 4:
                    text, ans, atype = ("do they watch the game?",
                                        str(rng.choice(("yes", "no"))),
                                        "yes/no")
                else:
                    text, ans, atype = ("what is on the plate?", str(
                        rng.choice(("hot dog", "orange", "pizza", "cake"))),
                        "other")
                qid = image_id * 10 + q
                qs.append({"image_id": image_id, "question": text,
                           "question_id": qid})
                others = [str(rng.choice(RAW_FILLER)) for _ in range(3)]
                answers = [ans] * (7 + rng.randint(4))
                answers += others[:10 - len(answers)]
                qannos.append({
                    "question_id": qid, "image_id": image_id,
                    "question_type": " ".join(text.split()[:3]),
                    "answer_type": atype, "multiple_choice_answer": ans,
                    "answers": [{"answer": a, "answer_confidence": "yes",
                                 "answer_id": j + 1}
                                for j, a in enumerate(answers)]})
            truth[image_id] = {"subset": subset, "pairs": len(names),
                               "captions": 5, "questions": n_q}
        short = subset[:-4]
        (ann_dir / f"instances_{subset}.json").write_text(json.dumps(
            {"images": images, "annotations": annos, "categories": cats}))
        (ann_dir / f"captions_{subset}.json").write_text(json.dumps(
            {"images": images, "annotations": caps}))
        (vqa_dir / f"questions/v2_OpenEnded_mscoco_{subset}_questions.json"
         ).write_text(json.dumps({"data_subtype": subset, "questions": qs}))
        (vqa_dir / f"anno/v2_mscoco_{subset}_annotations.json").write_text(
            json.dumps({"data_subtype": subset, "annotations": qannos,
                        "split": short}))
    return truth


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


def train_overrides(data_dir: Path, vocab_path: Path, *extra,
                    val: int = TRAIN_VAL) -> list:
    """The overrides of `configs/exp/gpv.yaml` for the train phases."""
    return [
        f"data_dir={data_dir}", f"output_dir={data_dir / 'exp'}",
        "exp_name=train", "learning_datasets=all",
        "task_configs.host_resize=exact", f"model.vocab={vocab_path}",
        f"training.batch_size={TRAIN_B}", "training.query_dedup=true",
        "training.run_vis_at_launch=false", "tb_dir=null",
        "training.num_val_samples={coco_vqa: %d, coco_cap: %d, "
        "coco_det: %d, coco_cls: %d}" % ((val,) * 4),
        f"device={DEVICE}"] + list(extra)


def write_train_samples(cfg, n_train: int = TRAIN_SAMPLES,
                        n_val: int = TRAIN_VAL) -> None:
    """The seeded train and val samples of each task, where `cfg` reads
    them."""
    for task in TRAIN_TASKS:
        samples = cfg.task_configs[EVAL_TASKS[task]].samples
        for subset, n in (("train", n_train), ("val", n_val)):
            path = Path(samples[subset])
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(eval_samples(task, n)))


def train_config(data_dir: Path, vocab_path: Path, *extra,
                 samples: bool = True):
    """`configs/exp/gpv.yaml` for the train phases, and (`samples`) the
    seeded train and val samples of each task written where it reads
    them."""
    from gpv_tpu_torch.utils.config import load_config
    cfg = load_config(ROOT / "configs", "exp/gpv",
                      train_overrides(data_dir, vocab_path, *extra))
    if samples:
        write_train_samples(cfg)
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
    from gpv_tpu_torch.utils import profiling

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
        # from the host batch (the upload is part of it): host ms by span
        profiling.drain()
        profiling.enable()
        t0 = time.perf_counter()
        trainer.train_step(trainer.state, batch)
        torch.cuda.synchronize()
        rec["step_ms"] = 1e3 * (time.perf_counter() - t0)
        profiling.disable()
        split = {}
        for r in profiling.drain():
            split[r.name] = split.get(r.name, 0.0) + 1e-6 * (r.end_ns
                                                             - r.start_ns)
        rec["step_host_ms_by_span"] = split
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
        rec["async"] = _async_round(trainer, cfg, batch)
        del trainer, model, saved, back
    torch.cuda.empty_cache()
    rec["eval"] = ev
    rec["seconds"] = time.perf_counter() - t_phase
    return rec, one_step, ev, ev_counts, batch, costs


def _async_round(trainer, cfg, batch) -> dict:
    """An async save on the released-width state, 2 steps at once while
    the write is in flight, the join, then a resume: the restored model
    and AdamW state must be the state at the save, not after the steps.
    Then a second async save on the path (its host buffers reused)."""
    import torch
    from gpv_tpu_torch.train.checkpoint import save_checkpoint, wait_for_saves

    out, saved = {}, _state_copy(trainer.state)
    t0 = time.perf_counter()
    save_checkpoint(cfg.ckpt_dir, trainer.state, {"epoch": 0}, name="async",
                    async_write=True)
    out["blocking_ms_first"] = 1e3 * (time.perf_counter() - t0)
    out["inflight_step_s"] = []
    for _ in range(2):
        t0 = time.perf_counter()
        trainer.train_step(trainer.state, batch)
        torch.cuda.synchronize()
        out["inflight_step_s"].append(time.perf_counter() - t0)
    moved = _state_copy(trainer.state)
    if all(torch.equal(moved[0][k], v) for k, v in saved[0].items()):
        fail("train: the steps during the async save moved nothing")
    t0 = time.perf_counter()
    wait_for_saves()
    out["join_s"] = time.perf_counter() - t0
    trainer._resume(Path(cfg.ckpt_dir) / "async")
    back = _state_copy(trainer.state)
    if back[2] != saved[2] or any(
            not torch.equal(back[0][k], v) for k, v in saved[0].items()):
        fail("train: the async save restored another model than the one "
             "at the save")
    for i, st in saved[1].items():
        for k, v in st.items():
            if not torch.equal(torch.as_tensor(back[1][i][k]),
                               torch.as_tensor(v)):
                fail(f"train: async-saved optimizer state {i}.{k} is not "
                     "the state at the save")
    out["restored_state_at_save"] = True
    t0 = time.perf_counter()
    save_checkpoint(cfg.ckpt_dir, trainer.state, {"epoch": 0}, name="async",
                    async_write=True)
    out["blocking_ms_reused"] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    wait_for_saves()
    out["write_s_reused"] = time.perf_counter() - t0
    out["bytes"] = (Path(cfg.ckpt_dir) / "async").stat().st_size
    return out


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
    want = by_variant(train_step_launches(E2E_TRAIN_B, False), "float32")
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


DATA_PREP_STEPS = 2
SCE_LINE = re.compile(r"^(\w+)/(\w+): kept (\d+), discarded (\d+)$")
PREP_TASKS = {"coco_detection": "pairs", "coco_classification": "pairs",
              "coco_captions": "captions", "coco_vqa": "questions"}


def _run_cli(main, argv) -> tuple:
    """(printed text, seconds) of one CLI's `main(argv)`, run from the
    root of the checkout (the CLIs read `configs/`)."""
    import io
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.chdir(ROOT), contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue(), time.perf_counter() - t0


def _prepare(data: Path) -> dict:
    """The raw tree, then the port's preprocess, SCE split and stats CLIs
    on it; the record and its gates (module docstring)."""
    from gpv_tpu_torch.cli import data_stats, make_sce_split, preprocess
    from gpv_tpu_torch.data import vocab_builder
    from gpv_tpu_torch.text.vocab import SPECIAL_TOKENS

    secs = {}
    t0 = time.perf_counter()
    truth = write_raw_coco(data)
    secs["raw_tree"] = time.perf_counter() - t0
    vocab_s, saved = [], (vocab_builder.build_vocab, vocab_builder.write_vocab)

    def timed(fn):
        def run(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                vocab_s.append(time.perf_counter() - t)
        return run
    vocab_builder.build_vocab, vocab_builder.write_vocab = map(timed, saved)
    try:
        printed, t = _run_cli(preprocess.main, [f"data_dir={data}"])
    finally:
        vocab_builder.build_vocab, vocab_builder.write_vocab = saved
    secs["preprocess"], secs["vocab"] = t - sum(vocab_s), sum(vocab_s)
    sce, secs["sce_split"] = _run_cli(make_sce_split.main, [
        f"data_dir={data}", "seed=0", "train_frac=0.9"])
    stats, secs["stats"] = _run_cli(data_stats.main, [
        f"data_dir={data}", "split=gpv_split"])

    lp = data / "learning_phase_data"
    load = lambda p: json.loads((lp / p).read_text())  # noqa: E731
    ids = {s: {i for i, t in truth.items() if t["subset"] == s}
           for s in ("train2014", "val2014")}
    for task, field in PREP_TASKS.items():  # the original split
        for subset, sub in (("train", "train2014"), ("val", "val2014")):
            n = len(load(f"{task}/original_split/{subset}.json"))
            want = sum(truth[i][field] for i in ids[sub])
            if n != want:
                fail(f"data_prep: {task}/original_split/{subset} holds {n} "
                     f"samples, the raw tree {want}")
    image_splits = load("coco_sce/image_splits.json")
    split_ids = {s: set(image_splits[s]["image_ids"])
                 for s in ("train", "val")}
    split_ids["test"] = set(image_splits["test"]["image_ids"])
    if split_ids["train"] & split_ids["val"] or \
            split_ids["train"] | split_ids["val"] != ids["train2014"] or \
            split_ids["test"] != ids["val2014"]:
        fail("data_prep: train/val are not a partition of train2014, or "
             "test is not val2014")
    samples = {}
    for ln in sce.splitlines():
        m = SCE_LINE.match(ln)
        if not m:
            continue
        task, subset, kept, dropped = m.groups()
        kept, dropped = int(kept), int(dropped)
        samples[f"{task}/{subset}"] = {"kept": kept, "discarded": dropped}
        want = sum(truth[i][PREP_TASKS[task]] for i in split_ids[subset])
        if kept + dropped != want or (subset == "test" and dropped):
            fail(f"data_prep: {task}/{subset} kept {kept} + discarded "
                 f"{dropped}, the raw tree gives {want}")
        rows = load(f"{task}/gpv_split/{subset}.json")
        image_ids = {r["image"]["image_id"] for r in rows}
        if len(rows) != kept or not image_ids <= split_ids[subset]:
            fail(f"data_prep: {task}/gpv_split/{subset} holds other "
                 "samples than its split's")
        if subset == "test" and {r["image"]["subset"] for r in rows} != {
                "val2014"}:
            fail(f"data_prep: {task} test samples not from val2014")
        if subset != "test" and any(r["coco_categories"]["unseen"]
                                    for r in rows):
            fail(f"data_prep: a {task}/{subset} sample carries an unseen "
                 "category")
    if len(samples) != 12:
        fail(f"data_prep: the SCE split printed {sorted(samples)}")
    split = load("coco_sce/category_split.json")
    sizes = [len(split[g]) for g in ("shared", "held_from_vqa",
                                     "held_from_det")]
    if sizes != [40, 10, 30] or split["shared"][0]["name"] != "person":
        fail(f"data_prep: category split {sizes}, shared first "
             f"{split['shared'][0]['name']}")
    vocab = load("vocab/vocab.json")
    if vocab != sorted(vocab) or not set(SPECIAL_TOKENS) <= set(vocab):
        fail("data_prep: the vocab is not sorted or lacks a special token")
    assigned = sum(v["kept"] + v["discarded"] for v in samples.values())
    return {"raw_images": {s: len(v) for s, v in ids.items()},
            "seconds_by_stage": secs, "samples": samples,
            "vocab_size": len(vocab), "vocab_printed": printed.strip(),
            "sce_samples_assigned": assigned,
            "sce_samples_per_s": assigned / secs["sce_split"],
            "stats_lines": len(stats.splitlines())}


def phase_data_prep(tmp: Path, checked: set):
    """Offline data preparation on a seeded raw COCO/VQA tree, a short
    training run on what it prepared with async checkpoints, and a predict
    from the trained checkpoint through the config entry point (module
    docstring). Returns the record, the train steps' {Case: launches} and
    the predict's."""
    import torch
    from gpv_tpu_torch.infer.build import build_engine
    from gpv_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                wait_for_saves)
    from gpv_tpu_torch.train.trainer import Trainer
    from gpv_tpu_torch.utils.config import load_config

    t_phase = time.perf_counter()
    data = tmp / "data_prep"
    rec = {"phase": "data_prep", **_prepare(data)}
    vocab_path = data / "learning_phase_data/vocab/vocab.json"
    cfg = train_config(data, vocab_path, "training.async_checkpoint=true",
                       "training.ckpt_step=1", samples=False)
    with seeded_pixel_datasets():
        t0 = time.perf_counter()
        trainer = Trainer(cfg)
        rec["train_setup_s"] = time.perf_counter() - t0
        rec["train_samples"] = len(trainer.datasets["train"])
        batches = iter(trainer.loaders["train"])
        waits, steps, blocking, rows, losses = [], [], [], [], []
        _reset_counts()
        for _ in range(DATA_PREP_STEPS):
            t0 = time.perf_counter()
            batch = next(batches)
            waits.append(1e3 * (time.perf_counter() - t0))
            rows.append(len(batch["query_uniq_ids"]))
            t0 = time.perf_counter()
            losses.append(_finite_losses("data_prep", trainer.train_step(
                trainer.state, batch)))
            torch.cuda.synchronize()
            steps.append(1e3 * (time.perf_counter() - t0))
            trainer.step += 1
            t0 = time.perf_counter()
            trainer.save_last(0)
            blocking.append(1e3 * (time.perf_counter() - t0))
        _, train_var = _read_counts()
        at_save = {k: v.detach().clone()
                   for k, v in trainer.model.state_dict().items()}
        batches.close()
        t0 = time.perf_counter()
        wait_for_saves()
        join_s = time.perf_counter() - t0
        train_counts = Counter()
        for u in rows:
            train_counts.update(train_step_launches(u, True))
        _check_counts("data_prep train", train_var, train_counts)
        if {c.name for c in train_counts} - checked:
            fail("data_prep: a train step's shape is not a kernels case")
        ckpt = Path(cfg.ckpt_dir) / "last"
        payload, meta = restore_checkpoint(ckpt.parent, ckpt.name)
        if payload["step"] != DATA_PREP_STEPS or set(payload["model"]) != \
                set(at_save) or any(not torch.equal(payload["model"][k],
                                                    v.cpu())
                                    for k, v in at_save.items()):
            fail("data_prep: ckpts/last is not the model at its save")
        del payload, at_save

        # the trained checkpoint through the entry point, against the
        # trainer's weights in memory
        items = [trainer.datasets["val"].get(i, np.random.RandomState(i))
                 for i in range(B)]
        images = np.stack([it["image"] for it in items])
        queries = [it["query"] for it in items]
        t0 = time.perf_counter()
        eng = build_engine(load_config(ROOT / "configs", "exp/gpv_inference", [
            f"ckpt={ckpt}", "tpu.dtype=bfloat16", f"model.vocab={vocab_path}",
            "device=cuda"]))
        rec["engine_build_s"] = time.perf_counter() - t0
        _reset_counts()
        got = eng.predict(images, queries)
        torch.cuda.synchronize()
        _, pred_var = _read_counts()
        decode_steps = eng.last_decode_steps
        pred_counts = path_launches("predict", decode_steps)
        _check_counts("data_prep predict", pred_var, pred_counts)
        if {c.name for c in pred_counts} - checked:
            fail("data_prep: a predict shape is not a kernels case")
        _check_boxes(got)
        # the trainer's weights in memory, taken as build_engine takes a
        # checkpoint's: BN folded on the host (a fold on the card rounds
        # otherwise), then cast and moved
        trainer.engine.load_weights(trainer.model.cpu())
        ref = trainer.engine.predict(images, queries)
        for a, b in zip(got, ref):
            if a["answer"] != b["answer"] or not np.array_equal(
                    a["boxes"], b["boxes"]) or not np.array_equal(
                        a["relevance"], b["relevance"]):
                fail("data_prep: the engine built from ckpts/last answers "
                     "otherwise than the trainer's weights in memory")
        del trainer, eng
    torch.cuda.empty_cache()
    rec.update({
        "train": {"batch": TRAIN_B, "steps": DATA_PREP_STEPS,
                  "workers": int(cfg.training.num_workers),
                  "dedup_rows": rows, "step_ms": steps,
                  "loader_wait_ms": waits, "losses": losses,
                  "async_save_blocking_ms": blocking, "join_s": join_s,
                  "checkpoint_bytes": ckpt.stat().st_size,
                  "launches_by_variant": train_var},
        "predict": {"batch": B, "decode_steps": decode_steps,
                    "launches_by_variant": pred_var,
                    "engine_equals_in_memory": True},
        "seconds": time.perf_counter() - t_phase})
    return rec, train_counts, pred_counts


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


# ------------------------------------------------- data parallelism (ddp)


def _sync() -> None:
    import torch
    if torch.device(DEVICE).type == "cuda":
        torch.cuda.synchronize()


def _peak_reset() -> None:
    import torch
    if torch.device(DEVICE).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _peak() -> int:
    import torch
    return (torch.cuda.max_memory_allocated()
            if torch.device(DEVICE).type == "cuda" else 0)


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(task: str, directory: Path, world: int = 2,
                timeout: float = RANK_TIMEOUT_S) -> list:
    """Run `task` (RANK_TASKS) as `world` fresh processes of this script,
    the ranks of one group on this host (the torchrun variables set), each
    reading `directory/spec.json`. Every rank must exit 0 within `timeout`
    s, else all are killed and the phase fails. Returns each rank's
    record."""
    port = _free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        log = open(directory / f"{task}_rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--rank-task",
             task, "--rank-dir", str(directory)], cwd=ROOT, env=env,
            stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + timeout
    hung = None
    try:
        for r, (p, _) in enumerate(procs):
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                hung = r
                break
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for r, (p, _) in enumerate(procs):
        if hung is not None or p.returncode != 0:
            tail = (directory / f"{task}_rank{r}.log").read_text()[-3000:]
            print(f"--- {task} rank {r} (exit {p.returncode}):\n{tail}",
                  file=sys.stderr, flush=True)
    if hung is not None:
        fail(f"{task}: rank {hung} did not finish in {timeout} s")
    for r, (p, _) in enumerate(procs):
        if p.returncode != 0:
            fail(f"{task}: rank {r} exited {p.returncode}")
    return [json.loads((directory / f"{task}_rank{r}.json").read_text())
            for r in range(world)]


def _digest(*objs) -> str:
    """sha256 over every tensor (in key order) and scalar of nested dicts:
    two states with one digest are bit-equal."""
    import hashlib

    import torch
    h = hashlib.sha256()

    def walk(o):
        if isinstance(o, torch.Tensor):
            h.update(o.detach().cpu().contiguous().view(-1).view(
                torch.uint8).numpy().tobytes())
        elif isinstance(o, dict):
            for k in sorted(o, key=str):
                h.update(str(k).encode())
                walk(o[k])
        elif isinstance(o, (list, tuple)):
            for v in o:
                walk(v)
        else:
            h.update(repr(o).encode())
    for o in objs:
        walk(o)
    return h.hexdigest()


def _assignment(model, b) -> "torch.Tensor":
    """The Hungarian assignment of a train forward on `b` (device
    tensors), -1 where a target is not valid."""
    import torch
    from gpv_tpu_torch.ops.image import normalize_image
    from gpv_tpu_torch.ops.matcher import hungarian_match
    with torch.no_grad():
        pred = model(normalize_image(b["image"].float() / 255.0),
                     b["query_ids"], b["answer_ids"],
                     query_valid=b["query_valid"], train=True)
    valid = b["box_valid"] & b["has_boxes"][:, None]
    q4t = hungarian_match(pred["pred_relevance_logits"], pred["pred_boxes"],
                          b["box_labels"], b["boxes"], valid)
    return torch.where(valid, q4t, -1).cpu()


def _one_step(model, cfg, rows, dtype=None):
    """One train step of `model` on `rows` (numpy): (losses, the clipped
    gradients on the CPU, the launches by variant)."""
    import torch
    from gpv_tpu_torch.losses.criterion import LossConfig
    from gpv_tpu_torch.parallel.train_step import TrainState, make_train_step
    from gpv_tpu_torch.train.optimizer import build_optimizer
    opt, sched = build_optimizer(cfg.training, 10, model)
    step = make_train_step(model, LossConfig.from_config(cfg.losses),
                           float(cfg.training.clip_max_norm),
                           dtype=dtype or torch.float32)
    _reset_counts()
    losses = step(TrainState(model, opt, sched), rows)
    _sync()
    return ({k: float(v) for k, v in losses.items()},
            {n: p.grad.detach().cpu() for n, p in model.named_parameters()
             if p.grad is not None}, _read_counts()[1])


def _grad_err(got: dict, want: dict, kinks: Optional[dict] = None) -> tuple:
    """The worst per-leaf error over max(1, max|want|), and its leaf; with
    `kinks` (`_kinks`), leaving out the entries a kinked unit feeds, whose
    worst error over the same scale comes third."""
    if set(got) != set(want):
        fail("ddp: gradient leaves differ: "
             f"{sorted(set(got) ^ set(want))[:4]}")
    worst, name, kinked = 0.0, None, 0.0
    for n, w in want.items():
        diff = (got[n] - w).abs() / max(1.0, w.abs().max().item())
        if kinks:
            mask = _kink_mask(n, w, kinks)
            if mask.any():
                kinked = max(kinked, diff[mask].max().item())
            diff = diff[~mask]
        err = diff.max().item() if diff.numel() else 0.0
        if err > worst:
            worst, name = err, n
    return (worst, name, kinked) if kinks is not None else (worst, name)


def _loss_err(got: dict, want: dict) -> float:
    return max(abs(got[k] - v) / max(abs(v), 1e-6) for k, v in want.items())


def rank_step(spec: dict, d: Path) -> dict:
    """A rank of ddp (b) and (c): one fp32 step (TF32 off) on its rows of
    the global DDP_B batch against (a)'s step, the assignment on its rows,
    a digest of its parameters; then DDP_TIMED_STEPS timed bf16 steps on
    its rows of the global TRAIN_B batch, its peak memory and the gloo
    all-reduce of the trainable fp32 gradients."""
    import copy

    import torch
    import torch.distributed as dist
    from gpv_tpu_torch.models.gpv import build_gpv
    from gpv_tpu_torch.parallel import mesh
    from gpv_tpu_torch.parallel.train_step import batch_to_device
    from gpv_tpu_torch.utils.config import load_config
    from gpv_tpu_torch.weights import init_random

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cluster = mesh.initialize_distributed({}, spec["device"])
    rank, world = cluster.rank, cluster.world
    dev = mesh.rank_device(cluster, spec["device"])
    out = {"rank": rank, "world": world, "device": str(dev),
           "backend": dist.get_backend()}
    cfg = load_config(ROOT / "configs", "exp/gpv", spec["overrides"])
    base = init_random(build_gpv(cfg.model, spec["vocab_size"]), seed=1)
    batch = dict(np.load(d / "batch.npz"))
    rows = mesh.shard_rows(len(batch["image"]), world, rank)
    local = {k: v[rows] for k, v in batch.items()}
    ref = torch.load(d / "ref.pt", weights_only=False)

    model = copy.deepcopy(base).to(dev)
    q4t = _assignment(model, batch_to_device(local, dev))
    out["assignment_equal"] = bool(torch.equal(q4t, ref["q4t"][rows]))
    losses, grads, out["launches_by_variant"] = _one_step(model, cfg, local)
    out["losses"] = losses
    out["loss_max_rel_err"] = _loss_err(losses, ref["losses"])
    out["grad_max_err"], out["grad_worst_leaf"] = _grad_err(grads,
                                                            ref["grads"])
    out["params_digest"] = _digest(model.state_dict())
    del model, grads
    torch.cuda.empty_cache()

    big = dict(np.load(d / "batch_big.npz"))
    rows = mesh.shard_rows(len(big["image"]), world, rank)
    resident = batch_to_device({k: v[rows] for k, v in big.items()}, dev)
    model = copy.deepcopy(base).to(dev)
    del base
    from gpv_tpu_torch.losses.criterion import LossConfig
    from gpv_tpu_torch.parallel.train_step import TrainState, make_train_step
    from gpv_tpu_torch.train.optimizer import build_optimizer
    opt, sched = build_optimizer(cfg.training, 10, model)
    state = TrainState(model, opt, sched)
    step = make_train_step(model, LossConfig.from_config(cfg.losses),
                           float(cfg.training.clip_max_norm),
                           dtype=torch.bfloat16)
    step(state, resident)  # warm-up
    _sync()
    _peak_reset()
    mesh.host_barrier()
    _reset_counts()
    times = []
    for _ in range(DDP_TIMED_STEPS):
        t0 = time.perf_counter()
        step(state, resident)
        _sync()
        times.append(1e3 * (time.perf_counter() - t0))
    out["timed"] = {"rows": len(rows), "step_ms": times,
                    "launches_by_variant": _read_counts()[1],
                    "peak_memory_bytes": _peak()}
    n = sum(p.numel() for p in model.parameters() if p.requires_grad)
    flat = torch.zeros(n, device=dev)
    dist.all_reduce(flat)
    _sync()
    ar = []
    for _ in range(3):
        mesh.host_barrier()
        t0 = time.perf_counter()
        dist.all_reduce(flat)
        _sync()
        ar.append(1e3 * (time.perf_counter() - t0))
    out["timed"]["allreduce_ms"] = ar
    out["timed"]["allreduce_bytes"] = 4 * n
    return out


def _saved_digest(state) -> str:
    """`_digest` of the model, the AdamW state and the step that a save
    writes: under tensor parallelism the whole state gathered over the
    model group (every rank of it calls this), else the state itself."""
    from gpv_tpu_torch.train.checkpoint import _payload
    p = _payload(state)
    return _digest(p["model"], p["optimizer"]["state"], p["step"])


def rank_cli(spec: dict, d: Path) -> dict:
    """A rank of ddp (d) or tp (d): `gpv_tpu_torch.cli.train.main` on
    seeded pixels. Records each `last` save's state digest (of the whole
    state, gathered under TP), the train steps' launches by variant and
    the state a resume restored; with `resume`, `train()` does nothing
    after the restore (auto_resume from ckpts/last). `then_resume`: the
    argv of a second launch in the same processes, after the first, that
    only restores."""
    import gc

    import torch
    from gpv_tpu_torch.cli import train as cli
    from gpv_tpu_torch.train import trainer as T

    out = {"saves": [], "train_launches": {}}
    save_last, make_step = T.Trainer.save_last, T.make_train_step
    resume = T.Trainer._resume

    def recording_save_last(self, epoch):
        save_last(self, epoch)
        out["saves"].append({"step": self.step,
                             "digest": _saved_digest(self.state)})

    def counted_step(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def run(state, batch):
            before = _read_counts()[1]
            losses = step(state, batch)
            after = _read_counts()[1]
            for w, variants in after.items():
                acc = out["train_launches"].setdefault(
                    w, dict.fromkeys(variants, 0))
                for v, n in variants.items():
                    acc[v] += n - before[w][v]
            out["rows"] = len(batch["query_ids"])
            return losses
        return run

    def recording_resume(self, path):
        resume(self, path)
        out["restored"] = {"step": self.step, "epoch": self.last_epoch,
                           "digest": _saved_digest(self.state)}

    T.Trainer.save_last = recording_save_last
    T.make_train_step = counted_step
    T.Trainer._resume = recording_resume
    if spec["resume"]:
        T.Trainer.train = lambda self: {}
    _reset_counts()
    with seeded_pixel_datasets():
        results = cli.main(spec["argv"])
        out["launches_by_variant"] = _read_counts()[1]
        if spec.get("then_resume"):
            gc.collect()
            torch.cuda.empty_cache()
            T.Trainer.train = lambda self: {}
            cli.main(spec["then_resume"])
    out["results"] = {k: float(v) for k, v in (results or {}).items()}
    return out



def rank_main(task: str, directory: Path) -> None:
    """Entry of a spawned rank: run RANK_TASKS[task] and write its record
    to `<task>_rank<r>.json`."""
    sys.path.insert(0, str(ROOT))
    import torch.distributed as dist
    global DEVICE
    spec = json.loads((directory / "spec.json").read_text())
    DEVICE = spec["device"]
    rec = RANK_TASKS[task](spec, directory)
    (directory / f"{task}_rank{os.environ['RANK']}.json").write_text(
        json.dumps(rec))
    if dist.is_initialized():
        dist.destroy_process_group()


def _ddp_rows(batch: dict, n: int) -> dict:
    return {k: v[:n] for k, v in batch.items()
            if not k.startswith("query_uniq") and k != "query_gather"}


def phase_ddp(vocab_path: Path, tmp: Path, batch: dict, checked: set):
    """Data parallelism (module docstring): (a) one NCCL rank through
    `initialize_distributed` and DDP against the plain step; (b) and (c)
    two gloo ranks on this card (`rank_step`); (d) `cli.train` as two
    ranks, a resume from rank 0's `ckpts/last` (`rank_cli`). Returns the
    record and {path: (record, {Case: launches})} for the kernels line."""
    import copy

    import torch
    import torch.distributed as dist
    from gpv_tpu_torch.models.gpv import build_gpv
    from gpv_tpu_torch.parallel import mesh
    from gpv_tpu_torch.parallel.train_step import batch_to_device
    from gpv_tpu_torch.text.vocab import AnswerVocab
    from gpv_tpu_torch.utils.config import load_config
    from gpv_tpu_torch.weights import init_random

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    d = tmp / "ddp"
    d.mkdir()
    overrides = train_overrides(tmp / "train_data", vocab_path,
                                "tpu.dtype=float32",
                                "model.detr.dropout=0.0")
    cfg = load_config(ROOT / "configs", "exp/gpv", overrides)
    vocab_size = len(AnswerVocab.load(vocab_path))
    base = init_random(build_gpv(cfg.model, vocab_size), seed=1)
    rows = _ddp_rows(batch, DDP_B)
    np.savez(d / "batch.npz", **rows)
    np.savez(d / "batch_big.npz", **_ddp_rows(batch, TRAIN_B))
    rec = {"phase": "ddp", "batch": DDP_B, "dtype": "float32"}

    model = copy.deepcopy(base).to(DEVICE)
    q4t = _assignment(model, batch_to_device(rows, DEVICE))
    plain, plain_grads, _ = _one_step(model, cfg, rows)
    plain_params = {k: v.detach().clone() for k, v in
                    model.state_dict().items()}
    del model

    # (a) one rank, NCCL, through the config keys and DDP
    cluster = mesh.initialize_distributed(
        {"distributed": {"coordinator_address": f"127.0.0.1:{_free_port()}",
                         "num_processes": 1, "process_id": 0}}, DEVICE)
    model = copy.deepcopy(base).to(DEVICE)
    del base
    losses, grads, a_var = _one_step(model, cfg, rows)
    a = {"backend": dist.get_backend(), "world": cluster.world,
         "losses": losses, "launches_by_variant": a_var,
         "loss_max_rel_err": _loss_err(losses, plain)}
    a["param_max_abs_err"] = max(
        (v - plain_params[k]).abs().max().item()
        for k, v in model.state_dict().items())
    dist.destroy_process_group()
    if a["backend"] != ("nccl" if DEVICE == "cuda" else "gloo"):
        fail(f"ddp (a): one rank on its own card joined over {a['backend']}")
    if not (a["loss_max_rel_err"] <= 1e-5 and a["param_max_abs_err"] <= 1e-5):
        fail(f"ddp (a): DDP step off the plain step: {a}")
    want = by_variant(train_step_launches(DDP_B, False), "float32")
    want["fused_attention"]["tile"] = 0
    if a_var != want:
        fail(f"ddp (a): launches {a_var} != {want}")
    torch.save({"losses": losses, "grads": grads, "q4t": q4t}, d / "ref.pt")
    rec["a"] = a
    del model, grads, plain_grads, plain_params
    torch.cuda.empty_cache()

    # (b) and (c): two gloo ranks on this one card
    (d / "spec.json").write_text(json.dumps(
        {"device": DEVICE, "overrides": overrides,
         "vocab_size": vocab_size}))
    t0 = time.perf_counter()
    ranks = spawn_ranks("step", d)
    rec["ranks_s"] = time.perf_counter() - t0
    half = DDP_B // 2
    want = by_variant(train_step_launches(half, False), "float32")
    want["fused_attention"]["tile"] = 0
    timed_counts = Counter({c: DDP_TIMED_STEPS * n for c, n in
                            train_step_launches(TRAIN_B // 2,
                                                False).items()})
    for r in ranks:
        if r["backend"] != "gloo":
            fail(f"ddp (b): two ranks on one card joined over {r['backend']}")
        if not (r["loss_max_rel_err"] <= 1e-4 and r["grad_max_err"] <= 1e-3
                and r["assignment_equal"]):
            keys = ("loss_max_rel_err", "grad_max_err", "grad_worst_leaf",
                    "assignment_equal")
            fail(f"ddp (b): rank {r['rank']} off the one-rank step: "
                 f"{ {k: r[k] for k in keys} }")
        if r["launches_by_variant"] != want:
            fail(f"ddp (b): rank {r['rank']} launches "
                 f"{r['launches_by_variant']} != {want}")
        _check_counts(f"ddp (c) rank {r['rank']}",
                      r["timed"]["launches_by_variant"], timed_counts)
    if ranks[0]["params_digest"] != ranks[1]["params_digest"]:
        fail("ddp (b): the ranks' parameters differ after the step")
    slowest = max(sum(r["timed"]["step_ms"]) for r in ranks) / 1e3
    rec["b"] = [{k: r[k] for k in ("rank", "backend", "device", "losses",
                                   "loss_max_rel_err", "grad_max_err",
                                   "grad_worst_leaf", "assignment_equal",
                                   "launches_by_variant")} for r in ranks]
    rec["b_params_bit_equal"] = True
    rec["c"] = {"global_batch": TRAIN_B, "dtype": "bfloat16",
                "steps": DDP_TIMED_STEPS,
                "images_per_s": DDP_TIMED_STEPS * TRAIN_B / slowest,
                "ranks": [r["timed"] for r in ranks],
                "note": "two ranks share one card: the mechanism, not "
                        "2-card scaling"}

    # (d) the entry point: cli.train as two ranks, then a resume
    data = tmp / "ddp_data"
    cli_over = train_overrides(
        data, vocab_path, "exp_name=ddp", "training.query_dedup=false",
        "training.num_epochs=1", "training.ckpt_step=1",
        "training.async_checkpoint=true", "training.num_workers=4",
        "eval.num_workers=4", f"eval.batch_size={B}", val=DDP_CLI_VAL)
    write_train_samples(load_config(ROOT / "configs", "exp/gpv", cli_over),
                        DDP_CLI_SAMPLES, DDP_CLI_VAL)
    runs = {}
    for name, extra, resume in (
            ("train", [], False),
            ("resume", ["training.num_epochs=2", "training.auto_resume=true"],
             True)):
        (d / "spec.json").write_text(json.dumps(
            {"argv": cli_over + extra, "resume": resume,
             "device": DEVICE}))
        t0 = time.perf_counter()
        runs[name] = spawn_ranks("cli", d)
        runs[name + "_s"] = time.perf_counter() - t0
        for r in range(2):
            os.replace(d / f"cli_rank{r}.json", d / f"cli_{name}_{r}.json")
    train, resumed = runs["train"], runs["resume"]
    steps = len(TRAIN_TASKS) * DDP_CLI_SAMPLES // TRAIN_B
    step_counts = Counter({c: steps * n for c, n in train_step_launches(
        TRAIN_B // 2, False).items()})
    for r, (t, s) in enumerate(zip(train, resumed)):
        if [x["step"] for x in t["saves"]] != list(range(1, steps + 1)):
            fail(f"ddp (d): rank {r} saved at {t['saves']}")
        _check_counts(f"ddp (d) rank {r} train", t["train_launches"],
                      step_counts)
        if s["restored"]["step"] != steps or \
                s["restored"]["digest"] != t["saves"][-1]["digest"]:
            fail(f"ddp (d): rank {r} restored {s['restored']} != its state "
                 f"at the last save {t['saves'][-1]}")
    if train[0]["saves"] != train[1]["saves"]:
        fail("ddp (d): the ranks' states differ at the saves")
    if set(train[0]["results"]) != TRAIN_EVAL_KEYS or train[1]["results"]:
        fail(f"ddp (d): rank 0's eval {train[0]['results']}, rank 1's "
             f"{train[1]['results']}")
    rec["d"] = {"steps": steps, "rank_batch": TRAIN_B // 2,
                "train_s": runs["train_s"], "resume_s": runs["resume_s"],
                "eval": train[0]["results"],
                "launches_by_variant": [t["launches_by_variant"]
                                        for t in train],
                "train_launches_by_variant": [t["train_launches"]
                                              for t in train],
                "restored_equal": True}
    checked_now = {c.name for counts in (
        step_counts, timed_counts, train_step_launches(DDP_B, False),
        train_step_launches(DDP_B // 2, False)) for c in counts}
    if checked_now - checked:
        fail(f"ddp: shapes not held in the kernels phase: "
             f"{sorted(checked_now - checked)}")
    rec["seconds"] = time.perf_counter() - t_phase
    return rec, {
        "ddp_timed_rank0": ({"launches_by_variant":
                             ranks[0]["timed"]["launches_by_variant"]},
                            timed_counts),
        "ddp_cli_rank0": ({"launches_by_variant":
                           train[0]["train_launches"]}, step_counts),
        "ddp_cli_rank1": ({"launches_by_variant":
                           train[1]["train_launches"]}, step_counts)}


# ------------------------------------------------- remat

def phase_remat(vocab_path: Path, tmp: Path, batch: dict):
    """`tpu.remat`: TRAIN_B bf16 steps on one resident batch without and
    with remat (peak memory, step ms); then fp32 at REMAT_CHECK_B with
    dropout on and cuDNN deterministic: every gradient of remat against
    no-remat. Returns the record and the timed steps' {Case: launches}."""
    import copy

    import torch
    from gpv_tpu_torch.losses.criterion import LossConfig, gpv_criterion
    from gpv_tpu_torch.models.gpv import build_gpv
    from gpv_tpu_torch.nn.layers import dropout_generator
    from gpv_tpu_torch.ops.image import normalize_image
    from gpv_tpu_torch.parallel.train_step import (TrainState,
                                                   batch_to_device,
                                                   make_train_step)
    from gpv_tpu_torch.text.vocab import AnswerVocab
    from gpv_tpu_torch.train.optimizer import build_optimizer, frozen_names
    from gpv_tpu_torch.weights import init_random

    t_phase = time.perf_counter()
    cfg = train_config(tmp / "train_data", vocab_path, samples=False)
    vocab_size = len(AnswerVocab.load(vocab_path))
    base = init_random(build_gpv(cfg.model, vocab_size), seed=2)
    resident = batch_to_device(_ddp_rows(batch, TRAIN_B), DEVICE)
    rec = {"phase": "remat", "batch": TRAIN_B, "dtype": "bfloat16"}
    counts = Counter({c: REMAT_STEPS * n for c, n in train_step_launches(
        TRAIN_B, False).items()})
    for remat in (False, True):
        model = build_gpv(cfg.model, vocab_size, remat=remat)
        model.load_state_dict(base.state_dict())
        model.to(DEVICE)
        opt, sched = build_optimizer(cfg.training, 10, model)
        state = TrainState(model, opt, sched)
        step = make_train_step(model, LossConfig.from_config(cfg.losses),
                               float(cfg.training.clip_max_norm),
                               dtype=torch.bfloat16)
        step(state, resident)  # warm-up
        _sync()
        _peak_reset()
        _reset_counts()
        times = []
        for _ in range(REMAT_STEPS):
            t0 = time.perf_counter()
            _finite_losses("remat", step(state, resident))
            _sync()
            times.append(1e3 * (time.perf_counter() - t0))
        _, var = _read_counts()
        _check_counts(f"remat={remat}", var, counts)
        rec["remat" if remat else "plain"] = {
            "step_ms": times,
            "peak_memory_bytes": _peak(),
            "launches_by_variant": var}
        del model, opt, sched, state, step
        torch.cuda.empty_cache()
    rec["step_ms_ratio"] = (np.median(rec["remat"]["step_ms"])
                            / np.median(rec["plain"]["step_ms"]))
    rec["peak_memory_ratio"] = (rec["remat"]["peak_memory_bytes"]
                                / max(1, rec["plain"]["peak_memory_bytes"]))

    # gradients with dropout on, fp32, deterministic cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    rows = batch_to_device(_ddp_rows(batch, REMAT_CHECK_B), DEVICE)
    grads = {}
    try:
        for remat in (False, True):
            model = build_gpv(cfg.model, vocab_size, remat=remat)
            model.load_state_dict(base.state_dict())
            model.to(DEVICE)
            frozen = frozen_names(model)
            for n, p in model.named_parameters():
                p.requires_grad_(n not in frozen)
            gen = torch.Generator(device=DEVICE).manual_seed(5)
            with dropout_generator(gen):
                out = model(normalize_image(rows["image"].float() / 255.0),
                            rows["query_ids"], rows["answer_ids"],
                            query_valid=rows["query_valid"], train=True)
                total, _ = gpv_criterion(out, rows,
                                         LossConfig.from_config(cfg.losses))
            total.backward()
            grads[remat] = {n: p.grad.detach().cpu()
                            for n, p in model.named_parameters()
                            if p.grad is not None}
            del model, out, total
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
        torch.use_deterministic_algorithms(False)
    if set(grads[True]) != set(grads[False]):
        fail("remat: other gradient leaves with remat")
    # relative to the leaf's largest gradient; a leaf whose gradient is 0
    # must be 0 with remat too
    worst, leaf = 0.0, None
    for n, g in grads[False].items():
        diff, scale = (grads[True][n] - g).abs().max().item(), \
            g.abs().max().item()
        err = diff / scale if scale else (0.0 if diff == 0 else np.inf)
        if err > worst:
            worst, leaf = err, n
    rec["check"] = {"batch": REMAT_CHECK_B, "dtype": "float32",
                    "dropout": float(cfg.model.detr.dropout),
                    "leaves": len(grads[False]), "grad_max_rel_err": worst,
                    "worst_leaf": leaf, "tol": 1e-5}
    if not worst <= 1e-5:
        fail(f"remat: gradient of {leaf} off no-remat's by {worst} relative")
    del base, grads, resident, rows
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t_phase
    return rec, counts


# ------------------------------------------------- tensor parallelism

def _tp_inputs(vocab_path: Path, n: int = TP_FWD_B) -> dict:
    """Seeded inputs of tp (b): uint8 images at IMG_H x IMG_W, queries of
    QUERY_TOKENS tokens padded to 20, 20 answer ids, the vocab's cls id."""
    from gpv_tpu_torch.text.vocab import AnswerVocab
    from gpv_tpu_torch.text.wordpiece import WordPieceTokenizer
    rng = np.random.RandomState(4)
    vocab = AnswerVocab.load(vocab_path)
    ids, valid = WordPieceTokenizer.debug().batch_encode(_queries(n, rng), 20)
    return {"image": rng.randint(0, 256, (n, IMG_H, IMG_W, 3)).astype(
                np.uint8),
            "query_ids": ids.astype(np.int64), "query_valid": valid,
            "answer_ids": rng.randint(0, len(vocab), (n, 20)),
            "cls_id": np.int64(vocab.cls_id)}


def _tp_forward(model, f: dict, dev) -> dict:
    """tp (b)'s deterministic forward of `model` on `_tp_inputs`: encode,
    the teacher-forced answer logits, a greedy decode; outputs in fp32 on
    the CPU."""
    import torch
    from gpv_tpu_torch.decode.greedy import greedy_decode
    from gpv_tpu_torch.ops.image import normalize_image
    t = {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in f.items()
         if k != "cls_id"}
    with torch.inference_mode():
        x = normalize_image(t["image"].float() / 255.0)
        memory, mem_valid, out = model.encode(x, t["query_ids"].long(), None,
                                              t["query_valid"])
        logits = model.decode_text(model.embed_answer_tokens(
            t["answer_ids"].long()), memory, mem_valid)
        tokens, step_logits, steps = greedy_decode(model, memory, mem_valid,
                                                   int(f["cls_id"]))
    return {"boxes": out["pred_boxes"].float().cpu(),
            "relevance_logits": out["pred_relevance_logits"].float().cpu(),
            "answer_logits": logits.float().cpu(),
            "logits0": step_logits[:, 0].float().cpu(),
            "tokens": tokens.cpu(), "steps": steps}


def _tp_dropout_shapes(rows: int) -> list:
    """(shape, sharded dim) of every dropout mask a TP step draws for a
    head- or width-sharded tensor at the released widths, `rows` rows:
    attention probabilities (DETR 6+6 layers, co-attention both ways x3,
    the text decoder x3) and the FFN hidden states (DETR, text decoder)."""
    hw, q, t, s = 300, 100, 20, 20
    return ([((rows, 8, hw, hw), 1), ((rows, hw, 2048), 2)] * 6
            + [((rows, 8, q, q), 1), ((rows, 8, q, hw), 1),
               ((rows, q, 2048), 2)] * 6
            + [((rows, 16, q, t), 1), ((rows, 16, t, q), 1)] * 3
            + [((rows, 8, s, s), 1), ((rows, 8, s, q + t), 1),
               ((rows, s, 2048), 2)] * 3)


def _tp_draw_ms(rows: int, dev) -> dict:
    """Device ms of one step's sharded dropout draws (`_tp_dropout_shapes`)
    drawn whole, as a rank draws them, against a rank's share alone
    (CUDA events, the median of 3); not measured off the card."""
    import torch
    out = {"elements_whole": sum(int(np.prod(s)) for s, _ in
                                 _tp_dropout_shapes(rows))}
    if torch.device(dev).type != "cuda":
        return dict(out, whole_ms=None, share_ms=None)
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, div in (("whole_ms", 1), ("share_ms", TP)):
        shapes = []
        for shape, dim in _tp_dropout_shapes(rows):
            shape = list(shape)
            shape[dim] //= div
            shapes.append(shape)
        times = []
        for _ in range(4):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            for shape in shapes:
                torch.rand(shape, generator=gen, device=dev)
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        out[name] = float(np.median(times[1:]))
    return out


@contextlib.contextmanager
def _ffn_signs(model, signs: dict):
    """Record into `signs` ({layer name: bool tensor on the CPU}), at the
    first forward of each DETR and text-decoder FFN in the block, where
    its ReLU's input is positive: (rows, tokens, this rank's units)."""
    import torch
    from gpv_tpu_torch.nn import detr_transformer, text_decoder
    from gpv_tpu_torch.parallel.tensor_parallel import column_linear
    names = {m: n for n, m in model.named_modules() if hasattr(m, "linear1")}
    real = detr_transformer.ffn

    def recording(layer, x, deterministic):
        name = names.get(layer)
        if name is not None and name not in signs:
            with torch.no_grad():
                signs[name] = (column_linear(x, layer.linear1, layer.ffn_tp)
                               > 0).cpu()
        return real(layer, x, deterministic)
    detr_transformer.ffn = text_decoder.ffn = recording
    try:
        yield signs
    finally:
        detr_transformer.ffn = text_decoder.ffn = real


def _kinks(model, signs: dict, plain: dict, rows) -> dict:
    """{FFN layer: the units (whole-layer indices) whose ReLU takes the
    other side of its kink here than in the plain step (`plain`, its
    `_ffn_signs` over every row) at some row and token}, joined over every
    rank (an all-reduce): there the two computations, which differ by
    rounding, differentiate another function."""
    import torch
    import torch.distributed as dist
    out = {}
    for name, mine in signs.items():
        n = mine.shape[-1]
        tp = model.get_submodule(name).ffn_tp
        lo = 0 if tp is None else tp.rank * n
        want = plain[name][torch.as_tensor(rows)][..., lo:lo + n]
        flag = torch.zeros(plain[name].shape[-1], dtype=torch.int32,
                           device=DEVICE)
        flag[lo:lo + n] = (mine != want).flatten(0, -2).any(0).to(
            flag.device, torch.int32)
        dist.all_reduce(flag)
        out[name] = flag.nonzero().flatten().tolist()
    return out


def _kink_mask(name: str, t, kinks: dict):
    """True at the entries of leaf `name` (shape of `t`) that a kinked
    unit of its FFN feeds: the unit's `linear1` row and bias entry and its
    `linear2` column."""
    import torch
    mask = torch.zeros(t.shape, dtype=torch.bool)
    layer, _, leaf = name.rpartition(".")
    layer, _, lin = layer.rpartition(".")
    units = kinks.get(layer) or []
    if units and lin == "linear1":
        mask[units] = True
    elif units and lin == "linear2" and leaf == "weight":
        mask[:, units] = True
    return mask


def _update_err(got: dict, want: dict, grads: dict,
                kinks: Optional[dict] = None) -> tuple:
    """Parameters after a step against the plain step's: the largest
    error where the plain gradient is determined (above 1e-3 of its leaf's
    largest and 1e-5; every entry of a leaf without a gradient), the rule
    of tests/test_torch_port_train_step.py, and the largest anywhere. A
    gradient that is zero up to rounding (the classifier transform's bias
    takes sum_v (p_v - y_v) = 0) moves AdamW's first update by +-lr either
    way. Entries a kinked unit feeds (`_kinks`) are not determined."""
    sure_err, any_err = 0.0, 0.0
    for k, v in got.items():
        diff = (v.cpu() - want[k]).abs()
        any_err = max(any_err, diff.max().item())
        g = grads.get(k)
        if g is not None:
            keep = g.abs() > max(1e-3 * g.abs().max().item(), 1e-5)
            diff = diff[keep & ~_kink_mask(k, g, kinks or {})]
        if diff.numel():
            sure_err = max(sure_err, diff.max().item())
    return sure_err, any_err


def rank_tp(spec: dict, d: Path) -> dict:
    """A rank of tp (a)-(c) on a (spec data, TP) mesh, the model sharded
    by `shard_params` from the phase's weights (`base.pt`): (a) one fp32
    step (TF32 off) on its data index's rows of the global DDP_B batch,
    against the plain step's losses, gradients and trained parameters in
    `ref.pt` (gathered over the model group; frozen leaves against
    `base.pt`), the assignment, digests of its replicated and
    of its sharded leaves, the launches by variant; with data 1 also a
    bf16 step on the same rows (the kernels line's launches); (b) with
    data 1, the deterministic fp32 forward (`fwd_rank<r>.pt`) and a bf16
    one, launches by variant; (c) with data 1, TP_TIMED_STEPS timed bf16
    steps at the released batch (dropout as released), peak memory, the
    TP all-reduces a step and their bytes, and the dropout draws' ms."""
    import copy

    import torch
    import torch.distributed as dist
    from gpv_tpu_torch.losses.criterion import LossConfig
    from gpv_tpu_torch.models.gpv import build_gpv, shard_params
    from gpv_tpu_torch.parallel import mesh
    from gpv_tpu_torch.parallel import tensor_parallel as tpl
    from gpv_tpu_torch.parallel.train_step import (TrainState,
                                                   batch_to_device,
                                                   make_train_step)
    from gpv_tpu_torch.train.optimizer import build_optimizer
    from gpv_tpu_torch.utils.config import load_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cluster = mesh.initialize_distributed(
        {"mesh": {"data": spec["data"], "model": TP}}, spec["device"])
    g, mg = mesh.groups(), mesh.model_group()
    dev = mesh.rank_device(cluster, spec["device"])
    out = {"rank": cluster.rank, "data_index": g.data_index,
           "model_index": g.model_index, "device": str(dev),
           "backend": dist.get_backend()}
    cfg = load_config(ROOT / "configs", "exp/gpv", spec["overrides"])
    base = torch.load(d / "base.pt", weights_only=True, mmap=True)

    def sharded(model_cfg=None):
        model = build_gpv(model_cfg or cfg.model, spec["vocab_size"])
        model.load_state_dict(base)
        model.to(dev)
        return model, shard_params(model, mg)

    def make_step(model, dtype, train_cfg=cfg):
        opt, sched = build_optimizer(train_cfg.training, 10, model)
        return TrainState(model, opt, sched), make_train_step(
            model, LossConfig.from_config(train_cfg.losses),
            float(train_cfg.training.clip_max_norm), dtype=dtype)

    # (a) one fp32 step against the plain step
    batch = dict(np.load(d / "batch.npz"))
    rows = mesh.shard_rows(len(batch["image"]), g.mesh.data, g.data_index)
    local = (batch if g.mesh.data == 1 else
             {k: v[rows] for k, v in _ddp_rows(batch, len(rows) *
                                               g.mesh.data).items()})
    ref = torch.load(d / "ref.pt", weights_only=False)
    model, rules = sharded()
    specs = rules.specs
    q4t = _assignment(model, batch_to_device(_ddp_rows(local, len(rows)),
                                             dev))
    state, step = make_step(model, torch.float32)
    _reset_counts()
    tpl.STATS.reset()
    with _ffn_signs(model, {}) as signs:
        losses = {k: float(v) for k, v in step(state, local).items()}
    _sync()
    a = {"rows": len(rows), "uniq_rows": len(local.get("query_uniq_ids",
                                                        ())),
         "losses": losses, "launches_by_variant": _read_counts()[1],
         "all_reduces": tpl.STATS.calls,
         "all_reduces_by_kind": dict(tpl.STATS.by_kind),
         "assignment_equal": bool(torch.equal(q4t, ref["q4t"][rows])),
         "loss_max_rel_err": _loss_err(losses, ref["losses"]),
         "sharded_leaves": len(specs),
         "replicated_heads": list(rules.replicated_heads)}
    kinks = _kinks(model, signs, ref["signs"], rows)
    a["kinked_units"] = {k: v for k, v in kinks.items() if v}
    grads = tpl.gather_shards({n: p.grad for n, p in
                               model.named_parameters()
                               if p.grad is not None}, specs, mg)
    a["grad_max_err"], a["grad_worst_leaf"], a["kinked_grad_max_err"] = \
        _grad_err({k: v.cpu() for k, v in grads.items()}, ref["grads"],
                  kinks)
    params = tpl.gather_shards(model.state_dict(), specs, mg)
    a["param_max_abs_err"], a["param_max_abs_err_all"] = _update_err(
        params, {**base, **ref["params"]}, ref["grads"], kinks)
    own = model.state_dict()
    a["replicated_digest"] = _digest({k: v for k, v in own.items()
                                      if k not in specs})
    a["shard_digest"] = _digest({k: v for k, v in own.items() if k in specs})
    out["a"] = a
    del model, state, step, grads, params, own, ref
    torch.cuda.empty_cache()
    if g.mesh.data > 1:
        return out

    # (a) again in bf16: the launches of the kernels line's tp_step
    model, _ = sharded()
    state, step = make_step(model, torch.bfloat16)
    _reset_counts()
    out["a_bf16"] = {"losses": {k: float(v) for k, v in
                                step(state, local).items()}}
    _sync()
    out["a_bf16"]["launches_by_variant"] = _read_counts()[1]
    del model, state, step
    torch.cuda.empty_cache()

    # (b) the deterministic forward, fp32 then bf16
    f = dict(np.load(d / "fwd.npz"))
    model, _ = sharded()
    model.eval()
    for name, dtype in (("b", torch.float32), ("b_bf16", torch.bfloat16)):
        model.to(dtype)
        _reset_counts()
        tpl.STATS.reset()
        res = _tp_forward(model, f, dev)
        _sync()
        out[name] = {"launches_by_variant": _read_counts()[1],
                     "all_reduces": tpl.STATS.calls, "steps": res["steps"]}
        if dtype == torch.float32:
            torch.save(res, d / f"fwd_rank{cluster.rank}.pt")
    del model
    torch.cuda.empty_cache()

    # (c) timed bf16 steps at the released batch and dropout
    big = batch_to_device(dict(np.load(d / "batch_big.npz")), dev)
    timed_cfg = load_config(ROOT / "configs", "exp/gpv",
                            spec["timed_overrides"])
    model, _ = sharded(timed_cfg.model)
    state, step = make_step(model, torch.bfloat16, timed_cfg)
    step(state, big)  # warm-up
    _sync()
    _peak_reset()
    mesh.host_barrier()
    _reset_counts()
    tpl.STATS.reset()
    times = []
    for _ in range(TP_TIMED_STEPS):
        t0 = time.perf_counter()
        _finite_losses("tp (c)", step(state, big))
        _sync()
        times.append(1e3 * (time.perf_counter() - t0))
    c = {"rows": len(big["query_ids"]),
         "uniq_rows": len(big["query_uniq_ids"]), "step_ms": times,
         "launches_by_variant": _read_counts()[1],
         "peak_memory_bytes": _peak(),
         "all_reduces_per_step": tpl.STATS.calls / TP_TIMED_STEPS,
         "all_reduce_bytes_per_step": tpl.STATS.bytes / TP_TIMED_STEPS,
         "all_reduces_by_kind_per_step": {
             k: n / TP_TIMED_STEPS for k, n in tpl.STATS.by_kind.items()}}
    mesh.host_barrier()
    tpl.STATS.reset()
    c["dropout_draws"] = _tp_draw_ms(c["rows"], dev)
    out["c"] = c
    return out


def phase_tp(vocab_path: Path, tmp: Path, batch: dict, checked: set,
             remat: dict):
    """Tensor parallelism (module docstring): (a)-(c) as ranks of this
    script (`rank_tp`) against the plain step and forward run here, (d)
    `cli.train` with tpu.mesh.model=TP and a TP resume of the `train`
    phase's one-process checkpoint in the same ranks (`rank_cli`), and a
    one-process resume of the TP checkpoint here.
    `remat`: remat's record, whose plain step (c) is held beside. Returns
    the record and {path: (record, {Case: launches})} for the kernels
    line."""
    import copy

    import torch
    from gpv_tpu_torch.datasets.loader import Collator
    from gpv_tpu_torch.models.gpv import build_gpv
    from gpv_tpu_torch.parallel.train_step import batch_to_device
    from gpv_tpu_torch.text.vocab import AnswerVocab
    from gpv_tpu_torch.train.checkpoint import restore_checkpoint
    from gpv_tpu_torch.train.trainer import Trainer
    from gpv_tpu_torch.utils.config import load_config
    from gpv_tpu_torch.weights import init_random

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    d = tmp / "tp"
    d.mkdir()
    overrides = train_overrides(tmp / "train_data", vocab_path,
                                "tpu.dtype=float32",
                                "model.detr.dropout=0.0")
    cfg = load_config(ROOT / "configs", "exp/gpv", overrides)
    vocab_size = len(AnswerVocab.load(vocab_path))
    base = init_random(build_gpv(cfg.model, vocab_size), seed=1)
    torch.save(base.state_dict(), d / "base.pt")
    if base.max_text_len != 20:
        fail(f"tp: max_text_len {base.max_text_len}, the cases assume 20")
    rows = _ddp_rows(batch, DDP_B)
    rows.update(Collator.dedup_emission(rows["query_ids"],
                                        rows["query_valid"],
                                        Collator.DEDUP_BUCKET))
    np.savez(d / "batch.npz", **rows)
    np.savez(d / "batch_big.npz", **batch)
    f = _tp_inputs(vocab_path)
    np.savez(d / "fwd.npz", **f)
    rec = {"phase": "tp", "model_axis": TP, "batch": DDP_B,
           "dtype": "float32"}

    # the plain one-process step and forward, here on the card
    model = copy.deepcopy(base).to(DEVICE)
    q4t = _assignment(model, batch_to_device(_ddp_rows(rows, DDP_B),
                                             DEVICE))
    with _ffn_signs(model, {}) as signs:
        losses, grads, _ = _one_step(model, cfg, rows)
    torch.save({"losses": losses, "grads": grads, "q4t": q4t,
                "signs": signs,
                "params": {k: v.detach().cpu() for k, v in
                           model.state_dict().items() if k in grads}},
               d / "ref.pt")
    del model, grads
    model = copy.deepcopy(base).to(DEVICE).eval()
    ref_fwd = _tp_forward(model, f, DEVICE)
    del model, base
    torch.cuda.empty_cache()

    spec = {"device": DEVICE, "overrides": overrides, "vocab_size":
            vocab_size, "timed_overrides": train_overrides(
                tmp / "train_data", vocab_path)}
    ranks = {}
    for data in (1, 2):
        (d / "spec.json").write_text(json.dumps(dict(spec, data=data)))
        t0 = time.perf_counter()
        ranks[data] = spawn_ranks("tp", d, world=data * TP)
        rec[f"ranks_{data}x{TP}_s"] = time.perf_counter() - t0
    u = len(rows["query_uniq_ids"])
    want = {1: by_variant(tp_step_launches(u, True), "float32"),
            2: by_variant(tp_step_launches(DDP_B // 2, False),
                          "float32")}
    rec["a"] = {}
    for data, rs in ranks.items():
        for r in rs:
            a = r["a"]
            if r["backend"] != "gloo":
                fail(f"tp (a): ranks sharing the card joined over "
                     f"{r['backend']}")
            if not (a["loss_max_rel_err"] <= 1e-4 and a["grad_max_err"]
                    <= 1e-3 and a["assignment_equal"]
                    and a["param_max_abs_err"] <= 1e-5):
                keys = ("loss_max_rel_err", "grad_max_err",
                        "grad_worst_leaf", "assignment_equal",
                        "param_max_abs_err", "param_max_abs_err_all",
                        "kinked_units", "kinked_grad_max_err")
                fail(f"tp (a) {data}x{TP}: rank {r['rank']} off the plain "
                     f"step: { {k: a[k] for k in keys} }")
            if a["launches_by_variant"] != want[data]:
                fail(f"tp (a) {data}x{TP}: rank {r['rank']} launches "
                     f"{a['launches_by_variant']} != {want[data]}")
            group = rs[r["rank"] - r["model_index"]]
            peer = rs[r["model_index"]]  # data index 0, same model index
            if a["replicated_digest"] != group["a"]["replicated_digest"]:
                fail(f"tp (a) {data}x{TP}: rank {r['rank']}'s replicated "
                     "leaves differ from its model group's")
            if a["shard_digest"] != peer["a"]["shard_digest"]:
                fail(f"tp (a) {data}x{TP}: rank {r['rank']}'s shards "
                     "differ from its data peer's")
        rec["a"][f"{data}x{TP}"] = [
            {k: r["a"][k] for k in (
                "rows", "uniq_rows", "losses", "loss_max_rel_err",
                "grad_max_err", "grad_worst_leaf", "param_max_abs_err",
                "param_max_abs_err_all", "kinked_units",
                "kinked_grad_max_err", "assignment_equal",
                "launches_by_variant", "all_reduces",
                "all_reduces_by_kind", "sharded_leaves",
                "replicated_heads")} for r in rs]
    rec["a_bit_equal"] = True
    r12 = ranks[1]
    step_counts = tp_step_launches(u, True)
    for r in r12:
        _check_counts(f"tp (a) bf16 rank {r['rank']}",
                      r["a_bf16"]["launches_by_variant"], step_counts)

    # (b) the forward against the unsharded one
    fwd = [torch.load(d / f"fwd_rank{r}.pt", weights_only=False)
           for r in range(TP)]
    b = {"batch": TP_FWD_B, "dtype": "float32",
         "launches_by_variant": r12[0]["b"]["launches_by_variant"],
         "bf16_launches_by_variant": r12[0]["b_bf16"]["launches_by_variant"],
         "all_reduces": r12[0]["b"]["all_reduces"]}
    for key, tol in (("boxes", 2e-4), ("relevance_logits", 5e-4),
                     ("answer_logits", 2e-3), ("logits0", 2e-3)):
        err = (fwd[0][key] - ref_fwd[key]).abs().max().item()
        b[f"{key}_max_abs_err"], b[f"{key}_tol"] = err, tol
        if not err <= tol:
            fail(f"tp (b) {key}: max abs err {err} > {tol}")
    b["greedy_token_agreement"] = (fwd[0]["tokens"] == ref_fwd["tokens"]) \
        .float().mean().item()
    for key in ("boxes", "answer_logits", "tokens"):
        if not torch.equal(fwd[0][key], fwd[1][key]):
            fail(f"tp (b): the ranks' {key} differ")
    fwd_counts = tp_forward_launches(steps=fwd[0]["steps"])
    for r in r12:
        _check_counts(f"tp (b) rank {r['rank']}",
                      r["b"]["launches_by_variant"], fwd_counts, "float32")
        _check_counts(f"tp (b) bf16 rank {r['rank']}",
                      r["b_bf16"]["launches_by_variant"], fwd_counts)
    rec["b"] = b

    # (c) timed, beside remat's one-process plain step
    timed_counts = Counter({c: TP_TIMED_STEPS * n for c, n in
                            tp_step_launches(len(batch["query_uniq_ids"]),
                                             True).items()})
    for r in r12:
        _check_counts(f"tp (c) rank {r['rank']}",
                      r["c"]["launches_by_variant"], timed_counts)
    slowest = max(sum(r["c"]["step_ms"]) for r in r12) / 1e3
    rec["c"] = {"global_batch": TRAIN_B, "dtype": "bfloat16",
                "steps": TP_TIMED_STEPS, "dedup": True,
                "images_per_s": TP_TIMED_STEPS * TRAIN_B / slowest,
                "ranks": [r["c"] for r in r12],
                "one_process_plain_step_ms": remat["plain"]["step_ms"],
                "one_process_peak_memory_bytes":
                    remat["plain"]["peak_memory_bytes"],
                "one_process_images_per_s": TRAIN_B / (np.median(
                    remat["plain"]["step_ms"]) / 1e3),
                "note": "two ranks share one card: the mechanism, not "
                        "2-card scaling; remat's plain step has no dedup"}

    # (d) cli.train under TP, then in the same ranks a TP resume of the
    # one-process `train` phase's checkpoint; a one-process resume of the
    # TP checkpoint, here
    data = tmp / "ddp_data"  # ddp (d)'s seeded samples
    cli_over = train_overrides(
        data, vocab_path, "exp_name=tp", "training.query_dedup=false",
        "training.num_epochs=1", "training.ckpt_step=1",
        "training.async_checkpoint=true", "training.num_workers=4",
        "eval.num_workers=4", f"eval.batch_size={B}", val=DDP_CLI_VAL)
    one_ckpt = tmp / "train_data" / "exp" / "train" / "ckpts" / "model"
    (d / "spec.json").write_text(json.dumps({
        "argv": cli_over + [f"tpu.mesh.model={TP}",  # data -1: one group
                            "training.run_eval_at_launch=false",
                            "training.num_val_samples={coco_vqa: 8, "
                            "coco_cap: 8, coco_det: 8, coco_cls: 8}"],
        "then_resume": cli_over + [f"tpu.mesh.model={TP}", "exp_name=tp_back",
                                   f"training.ckpt={one_ckpt}"],
        "resume": False, "device": DEVICE}))
    t0 = time.perf_counter()
    train = spawn_ranks("cli", d, world=TP)
    d_s = {"tp_ranks_s": time.perf_counter() - t0}
    steps = len(TRAIN_TASKS) * DDP_CLI_SAMPLES // TRAIN_B
    cli_counts = Counter({c: steps * n for c, n in tp_step_launches(
        TRAIN_B, False).items()})
    for r, t in enumerate(train):
        if [x["step"] for x in t["saves"]] != list(range(1, steps + 1)):
            fail(f"tp (d): rank {r} saved at {t['saves']}")
        _check_counts(f"tp (d) rank {r} train", t["train_launches"],
                      cli_counts)
    if train[0]["saves"] != train[1]["saves"]:
        fail("tp (d): the ranks gathered other states at the saves")
    if set(train[0]["results"]) != TRAIN_EVAL_KEYS or train[1]["results"]:
        fail(f"tp (d): rank 0's eval {train[0]['results']}, rank 1's "
             f"{train[1]['results']}")
    payload, _ = restore_checkpoint(one_ckpt.parent, one_ckpt.name)
    want = _digest(payload["model"], payload["optimizer"]["state"],
                   payload["step"])
    del payload
    for r, t in enumerate(train):
        if t["restored"]["digest"] != want:
            fail(f"tp (d): rank {r}'s gathered state after resuming the "
                 "one-process checkpoint differs from it")
    t0 = time.perf_counter()
    tp_last = data / "exp" / "tp" / "ckpts" / "last"
    with seeded_pixel_datasets():
        one = Trainer(load_config(ROOT / "configs", "exp/gpv", cli_over + [
            "exp_name=tp_one", f"training.ckpt={tp_last}"]))
    restored = {"step": one.step, "digest": _saved_digest(one.state)}
    del one
    torch.cuda.empty_cache()
    d_s["one_process_s"] = time.perf_counter() - t0
    if restored != {"step": steps, "digest": train[0]["saves"][-1]["digest"]}:
        fail(f"tp (d): one process restored {restored} != the TP state at "
             f"its last save {train[0]['saves'][-1]}")
    rec["d"] = {"steps": steps, "rank_batch": TRAIN_B, **d_s,
                "eval": train[0]["results"],
                "launches_by_variant": train[0]["launches_by_variant"],
                "train_launches_by_variant": [t["train_launches"]
                                              for t in train],
                "tp_to_one_process_equal": True,
                "one_process_to_tp_equal": True}

    checked_now = {c.name for counts in (
        step_counts, fwd_counts, timed_counts, cli_counts,
        tp_step_launches(DDP_B // 2, False)) for c in counts}
    if checked_now - checked:
        fail(f"tp: shapes not held in the kernels phase: "
             f"{sorted(checked_now - checked)}")
    rec["seconds"] = time.perf_counter() - t_phase
    return rec, {
        "tp_step": ({"launches_by_variant":
                     r12[0]["a_bf16"]["launches_by_variant"]}, step_counts),
        "tp_forward": ({"launches_by_variant":
                        r12[0]["b_bf16"]["launches_by_variant"]},
                       fwd_counts),
        "tp_step_bf16": ({"launches_by_variant":
                          r12[0]["c"]["launches_by_variant"]}, timed_counts),
        "tp_cli": ({"launches_by_variant": train[0]["train_launches"]},
                   cli_counts)}


RANK_TASKS = {"step": rank_step, "cli": rank_cli, "tp": rank_tp}


# ------------------------------------------------- multi-device inference

def _abba(calls: dict, n_iter: int = 5) -> dict:
    """images/s of two B-row calls {a, b}, measured a, b, b, a (n_iter
    calls each time), so that a drift of the machine falls on both."""
    (a, fa), (b, fb) = calls.items()
    out = {a: [], b: []}
    for name, fn in ((a, fa), (b, fb), (b, fb), (a, fa)):
        out[name].append(_images_per_s(fn, n_iter))
    return out


def phase_infer_dp(eng, vocab_path: Path, tmp: Path, checked: set):
    """`tpu.infer_data_parallel` and `GPVEngine(devices=...)` on the one
    card: -1 builds the plain engine (F3), bit for bit; an engine over
    cuda:0, cuda:0 against the one-device engine on a ragged batch of
    INFER_DP_N in fp32, and its bf16 images/s beside the engine's;
    export_engine refuses it. Returns the record and the bf16 two-shard
    predict's {Case: launches}."""
    import torch
    from gpv_tpu_torch.engine import GPVEngine
    from gpv_tpu_torch.export import export_engine
    from gpv_tpu_torch.infer.build import build_engine
    from gpv_tpu_torch.utils.config import load_config

    t_phase = time.perf_counter()
    rec = {"phase": "infer_dp"}
    images, queries = _batch(0, B)
    auto = build_engine(load_config(ROOT / "configs", "exp/gpv_inference", [
        "ckpt=null", "tpu.dtype=bfloat16", f"model.vocab={vocab_path}",
        f"device={DEVICE}", "tpu.infer_data_parallel=-1"]))
    if len(auto.devices) != 1:
        fail(f"infer_dp: -1 on one card gave devices {auto.devices}")
    for g, w in zip(auto.predict(images, queries),
                    eng.predict(images, queries)):
        if g["answer"] != w["answer"] or not np.array_equal(
                g["boxes"], w["boxes"]) or not np.array_equal(
                    g["relevance"], w["relevance"]):
            fail("infer_dp: infer_data_parallel=-1 answers otherwise than "
                 "the one-device engine")
    rec["minus_one_equals_plain"] = True
    del auto

    cfg = load_config(ROOT / "configs", "exp/gpv_inference", [
        "ckpt=null", f"model.vocab={vocab_path}"])
    two = [f"{DEVICE}:0", f"{DEVICE}:0"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    one32 = GPVEngine.from_config(cfg.model, eng.vocab, eng.tokenizer,
                                  dtype=torch.float32, device=DEVICE)
    two32 = GPVEngine.from_config(cfg.model, eng.vocab, eng.tokenizer,
                                  dtype=torch.float32, devices=two)
    ragged, rq = _batch(3, INFER_DP_N)
    want = one32.predict(ragged, rq)
    got = two32.predict(ragged, rq)
    rec["fp32"] = {"rows": INFER_DP_N, "shards": len(two),
                   "shard_steps": two32.last_shard_steps,
                   "max_scaled_err": _agree("infer_dp fp32", got, want,
                                            1e-3)}
    try:
        export_engine(two32, tmp / "infer_dp_export", batch_sizes=(2,))
    except ValueError as e:
        rec["export_refused"] = str(e)[:120]
    else:
        fail("infer_dp: export_engine took a multi-device engine")
    del one32, two32
    torch.cuda.empty_cache()

    two16 = GPVEngine.from_config(cfg.model, eng.vocab, eng.tokenizer,
                                  devices=two)
    two16.predict(images, queries)  # warm-up
    _sync()
    _reset_counts()
    got = two16.predict(images, queries)
    _sync()
    _, var = _read_counts()
    counts = Counter()
    for s in two16.last_shard_steps:
        counts.update(path_launches("predict", s, B // len(two)))
    _check_counts("infer_dp", var, counts)
    _check_boxes(got)
    if {c.name for c in counts} - checked:
        fail("infer_dp: a shape is not a kernels case")
    rec["bf16"] = {"batch": B, "shard_steps": two16.last_shard_steps,
                   "launches_by_variant": var,
                   "images_per_s": _abba(
                       {"one_device": lambda: eng.predict(images, queries),
                        "two_shards": lambda: two16.predict(images,
                                                            queries)})}
    del two16
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t_phase
    return rec, counts


# ------------------------------------------------- space-to-depth stem

def _stem_device_ms(trunk, x) -> dict:
    """Device ms of the stem conv alone, and of the whole stem input path
    (space-to-depth and pad included for the s2d stem), from the profiler
    over STEM_REPS calls each."""
    import torch
    import torch.nn.functional as F
    from gpv_tpu_torch.ops.stem_s2d import STEM_PAD, space_to_depth

    def prep(x):
        return F.pad(space_to_depth(x), STEM_PAD) if trunk.stem_s2d else x

    x = x.to(trunk.conv1.weight.dtype)
    with torch.inference_mode():
        xin = prep(x)
        out = {}
        for name, fn in (("conv_device_ms", lambda: trunk.conv1(xin)),
                         ("stem_device_ms", lambda: trunk.conv1(prep(x)))):
            for _ in range(3):
                fn()
            out[name] = _profiled_device_ms(fn, STEM_REPS)
    return out


def phase_stem_s2d(eng, vocab_path: Path, checked: set):
    """`model.detr.stem_s2d` at released width: fp32 predict with the s2d
    stem against the plain stem (answers equal, boxes 2e-4, relevance
    5e-4), bf16 images/s at B both ways, and the stem's device ms both
    ways. Returns the record and the bf16 s2d predict's {Case:
    launches}."""
    import torch
    from gpv_tpu_torch.infer.build import build_engine
    from gpv_tpu_torch.utils.config import load_config

    t_phase = time.perf_counter()
    rec = {"phase": "stem_s2d", "batch": B}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def build(dtype, s2d):
        return build_engine(load_config(
            ROOT / "configs", "exp/gpv_inference",
            ["ckpt=null", f"tpu.dtype={dtype}", f"model.vocab={vocab_path}",
             f"device={DEVICE}", f"model.detr.stem_s2d={str(s2d).lower()}"]))

    images, queries = _batch(4, B)
    plain32, s2d32 = build("float32", False), build("float32", True)
    if not s2d32.model.detr.trunk.stem_s2d:
        fail("stem_s2d: the engine was built without the s2d stem")
    want, got = plain32.predict(images, queries), s2d32.predict(images,
                                                                queries)
    worst = {"boxes": 0.0, "relevance": 0.0}
    for g, w in zip(got, want):
        if g["answer"] != w["answer"]:
            fail(f"stem_s2d: answer {g['answer']!r} != {w['answer']!r}")
        for key in worst:
            worst[key] = max(worst[key], float(np.abs(
                np.asarray(g[key]) - np.asarray(w[key])).max()))
    rec["fp32_max_abs_err"] = worst
    if not (worst["boxes"] <= 2e-4 and worst["relevance"] <= 5e-4):
        fail(f"stem_s2d: fp32 s2d predict off the plain stem's: {worst}")
    del plain32, s2d32
    torch.cuda.empty_cache()

    s2d16 = build("bfloat16", True)
    x = torch.from_numpy(images).to(DEVICE).permute(0, 3, 1, 2)
    for name, e in (("plain", eng), ("s2d", s2d16)):
        e.predict(images, queries)  # warm-up
        _sync()
        _reset_counts()
        out = e.predict(images, queries)
        _sync()
        _, var = _read_counts()
        counts = path_launches("predict", e.last_decode_steps)
        _check_counts(f"stem_s2d {name}", var, counts)
        _check_boxes(out)
        rec[name] = {
            "launches_by_variant": var,
            "conv1_weight_shape": list(e.model.detr.trunk.conv1.weight.shape),
            **_stem_device_ms(e.model.detr.trunk, x)}
    if {c.name for c in counts} - checked:
        fail("stem_s2d: a shape is not a kernels case")
    rec["images_per_s"] = _abba(
        {"plain": lambda: eng.predict(images, queries),
         "s2d": lambda: s2d16.predict(images, queries)})
    rec["stem_device_ms_ratio"] = (rec["s2d"]["stem_device_ms"]
                                   / rec["plain"]["stem_device_ms"])
    del s2d16
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t_phase
    return rec, ({"launches_by_variant": var}, counts)


def kernels_line(kern: dict, runs: dict, fp32_runs: dict,
                 msdeform: dict) -> dict:
    """One entry per kernel of the paths. Its top-level numbers are one
    predict's (the slice run in bf16, `e2e`'s timed predict in fp32): each
    shape's number in that dtype times its launches in that run, summed
    over the shapes that kernel serves; `paths` holds the same for each
    measured run (predict, predict_beam, embed_vocab, the whole serve run,
    the eval phase's gated runs). runs / fp32_runs: path -> (its phase
    record, {Case: launches}) of the bf16 / fp32 runs; msdeform: the
    `msdeform` phase's record (`msdeform_entries`)."""
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
    fp32 = [r for r in kern["K1"] if r["dtype"] == "float32"]
    k2_fp32 = [r for r in kern["K2"] if r["dtype"] == "float32"]

    def k2_call(recs, counts):
        out = per_call(recs, counts)
        out["library_ms"] = out["library_device_ms"] = None  # no one call
        names = {c.name: n for c, n in counts.items()}
        for k in ("sdpa_two_calls_ms", "sdpa_two_calls_device_ms"):
            out[k] = sum(names.get(r["case"], 0) * r[k] for r in recs)
        return out

    entries = []
    for name, source, replaces, wrapper, variant, recs, call, path_runs in (
            ("fused_attention[tile]", "attention_tile.cu", ":55",
             "fused_attention", "tile",
             [r for r in bf16 if r["variant"] == "tile"], per_call, runs),
            ("fused_attention[decode]", "attention_decode.cu", ":55",
             "fused_attention", "decode",
             [r for r in bf16 if r["variant"] == "decode"], per_call, runs),
            ("fused_biattention[tile]", "attention_tile.cu", ":147",
             "fused_biattention", "tile", k2_bf16, k2_call, runs),
            ("fused_attention[fp32_tile]", "attention.cu", ":55",
             "fused_attention", "fp32_tile",
             [r for r in fp32 if r["variant"] == "fp32_tile"], per_call,
             fp32_runs),
            ("fused_attention[fp32_decode]", "attention.cu", ":55",
             "fused_attention", "fp32_decode",
             [r for r in fp32 if r["variant"] == "fp32_decode"], per_call,
             fp32_runs),
            ("fused_biattention[fp32_tile]", "attention.cu", ":147",
             "fused_biattention", "fp32_tile", k2_fp32, k2_call,
             fp32_runs)):
        paths = {}
        for path, (rec, counts) in path_runs.items():
            n = rec["launches_by_variant"][wrapper][variant]
            paths[path] = {"launches": n, **call(recs, counts)}
        sl = paths["predict"]
        dtype = "bf16" if path_runs is runs else "fp32"
        entries.append({"name": name, "route": "cuda",
                        "source": f"gpv_tpu_torch/csrc/{source}",
                        "replaces": f"gpv_tpu/ops/attention.py{replaces}",
                        **sl, "per": f"one predict: B={B}, {dtype}, "
                        f"{path_runs['predict'][0]['decode_steps']} decode "
                        "steps", "paths": paths})
    return {"kernels": entries + msdeform_entries(msdeform)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--report", type=Path, default=None,
                    help="also write every phase's record to this file")
    ap.add_argument("--rank-task", choices=sorted(RANK_TASKS),
                    help=argparse.SUPPRESS)  # a rank this script spawns
    ap.add_argument("--rank-dir", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not (ROOT / "gpv_tpu_torch" / "csrc").is_dir():
        fail("gpv_tpu_torch/ not found beside chip_smoke.py: run it from a "
             "checkout of the repository")
    if args.rank_task:
        rank_main(args.rank_task, args.rank_dir)
        return
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
        deform = phase_msdeform(vocab_path)
        records.append(deform)
        emit(deform)
        t0 = time.perf_counter()
        eng = make_engine(vocab_path, "bfloat16", "cuda")
        sl, sl_counts, prof = phase_slice(eng, time.perf_counter() - t0)
        beam, beam_counts, prof_beam = phase_beam(eng)
        e2e, e2e_counts = phase_e2e(vocab_path)
        for rec in (sl, prof, beam, prof_beam, e2e):
            records.append(rec)
            emit(rec)
        checked = {r["case"] for r in kern["K1"] + kern["K2"]}
        wide, wide_runs, wide_bf16 = phase_wide_heads(vocab_path, checked)
        records.append(wide)
        emit(wide)
        records.append(phase_bench())
        emit(records[-1])
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
        idp, idp_counts = phase_infer_dp(eng, vocab_path, Path(tmp),
                                         checked)
        records.append(idp)
        emit(idp)
        st, st_run = phase_stem_s2d(eng, vocab_path, checked)
        records.append(st)
        emit(st)
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
        ddp, ddp_runs = phase_ddp(vocab_path, Path(tmp), batch, checked)
        records.append(ddp)
        emit(ddp)
        rm, rm_counts = phase_remat(vocab_path, Path(tmp), batch)
        records.append(rm)
        emit(rm)
        tp, tp_runs = phase_tp(vocab_path, Path(tmp), batch, checked, rm)
        records.append(tp)
        emit(tp)
        prep, prep_train, prep_pred = phase_data_prep(Path(tmp), checked)
        records.append(prep)
        emit(prep)
    line = kernels_line(kern, {
        "predict": (sl, sl_counts), "predict_beam": (beam, beam_counts),
        "embed_vocab": (ve, ve_counts), "serve": (serve, serve_counts),
        "eval": (ev, ev_counts),
        "train_step": ({"launches_by_variant": by_variant(tr_counts)},
                       tr_counts),
        "train_eval": (tr_eval, tr_eval_counts),
        "export": (ex, ex_counts),
        "data_prep_train": (prep["train"], prep_train),
        "data_prep_predict": (prep["predict"], prep_pred),
        "infer_dp": (idp["bf16"], idp_counts), "stem_s2d": st_run,
        "remat": (rm["remat"], rm_counts), **ddp_runs, **tp_runs,
        "wide_heads_predict": wide_bf16},
        {"predict": (e2e["fp32_predict"], e2e_counts), **wide_runs}, deform)
    records.append(line)
    seconds = time.perf_counter() - t_start
    if args.report:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(
            {"records": records, "seconds": seconds}, indent=1))
    emit({"phase": "total", "seconds": seconds})
    emit(line)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
