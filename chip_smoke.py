#!/usr/bin/env python3
"""Drive the PyTorch port (`gpv_tpu_torch`) on one CUDA card, end to end.

    python3 chip_smoke.py [--report PATH]

Run from the root of a checkout. Phases, each printing one JSON line:
  device   the card, and its name and power limit as nvidia-smi gives them;
  build    nvcc builds every kernel source of gpv_tpu_torch/csrc (sm_90a);
  kernels  K1 (fused_attention) and K2 (fused_biattention) against their
           plain PyTorch versions at every main-path shape, fp32 (TF32 off)
           and bf16, timed beside the plain version and SDPA: `ms` over 30
           back-to-back calls (host cost included) and `device_ms`, one
           launch's device time from a CUDA-graph replay of 30 launches;
  slice    GPVEngine.predict at the released width (B=20 uint8 480x640,
           12-token queries, bf16, BN folded, seeded random weights), with
           the kernels' launch counts read around that one call;
  profile  torch.profiler over one more predict: device time by kernel,
           the port's kernels (prefix gpv_attn_) by variant, and the
           device's idle share;
  e2e      the same weights in fp32 on the card (kernels) and on the CPU
           (plain versions), on 2 images: boxes, relevance, first-step
           logits, greedy tokens.
Then one `kernels` line (each kernel of the path: launches in the
measured predict, and per-predict ms, device ms, bound), and last
`{"ok": true, "device": {...}}`. Any failed phase exits non-zero before
that line; without a CUDA device, or without the package beside this file,
it exits non-zero at once. `--report` also writes every phase's record to
PATH as JSON.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}  # dense tensor core
TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # x max(1, |plain| max)
B, IMG_H, IMG_W, QUERY_TOKENS, VOCAB = 20, 480, 640, 12, 10000


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
    from gpv_tpu_torch.ops import _cuda
    seconds = _cuda.build_all()
    ptxas = [ln.strip() for name in _cuda.SOURCES
             for ln in _cuda.build_log(name).splitlines()
             if "Used" in ln or "spill" in ln]
    mma = {name: _sass_mma(_cuda._target(name)) for name in _cuda.SOURCES}
    tile = mma["attention_tile"]
    if tile and not all(tile.values()):
        fail(f"a tile kernel issues no tensor-core instruction: {tile}")
    return {"phase": "build", "sources": list(_cuda.SOURCES),
            "seconds": seconds, "ptxas": ptxas, "sass_mma_per_kernel": mma}


def k1_cases(steps: int):
    """(name, B, Tq, Tk, H, Dh, mask, causal, launches per predict)."""
    return [
        ("detr_encoder_self", B, 300, 300, 8, 32, None, False, 6),
        ("detr_decoder_self", B, 100, 100, 8, 32, None, False, 6),
        ("detr_decoder_cross", B, 100, 300, 8, 32, None, False, 6),
        ("bert_self", B, 20, 20, 12, 64, "query", False, 12),
        ("decode_step_self", B, 1, 20, 8, 96, "cache", False, 3 * steps),
        ("decode_step_cross", B, 1, 120, 8, 96, "memory", False, 3 * steps),
        ("teacher_forced_causal", B, 20, 20, 8, 96, None, True, 0),
    ]


def _valid(kind, Tk, device, g):
    """(B, Tk) key validity of the main path's kind, or random (at least
    the first key valid) for any other kind."""
    import torch
    if kind is None:
        return None
    if kind == "query":   # 12 real tokens of the padded 20
        return (torch.arange(Tk, device=device) < QUERY_TOKENS).expand(
            B, Tk).contiguous()
    if kind == "cache":   # decode position t = 9 of the 20-slot cache
        return (torch.arange(Tk, device=device) <= 9).expand(
            B, Tk).contiguous()
    if kind == "memory":  # 100 vision slots + 12 of 20 query slots
        idx = torch.arange(Tk, device=device)
        return (idx < 100 + QUERY_TOKENS).expand(B, Tk).contiguous()
    v = torch.rand(B, Tk, device=device, generator=g) > 0.3
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
            for name, b, tq, tk, h, dh, mk, causal, _ in k1_cases(0):
                q, k, v = (torch.randn(b, t, h, dh, device=dev, generator=g)
                           .to(dtype) for t in (tq, tk, tk))
                kv = _valid(mk, tk, dev, g)
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
                       "variant": A._plan(dtype, tq, tk, dh).variant,
                       "max_abs_err": err, "tol": TOL[dname] * scale,
                       **_timings(calls)}
                nbytes = (2 * q.numel() + k.numel() + v.numel()) \
                    * q.element_size() + (0 if kv is None else kv.numel())
                rec.update(_bound(nbytes, 4.0 * b * h * tq * tk * dh, dname))
                k1.append(rec)
            # K2: text T1=20 (12 valid) x vision T2=100, 16 heads, Dh 48
            t1, t2, h, dh = 20, 100, 16, 48
            xs = [torch.randn(B, t, h, dh, device=dev, generator=g).to(dtype)
                  for t in (t1, t1, t1, t2, t2, t2)]
            for has1, has2 in ((True, False), (False, False), (True, True),
                               (False, True)):
                v1 = _valid("query", t1, dev, g) if has1 else None
                v2 = _valid("random", t2, dev, g) if has2 else None
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
                rec = {"case": f"masks_{int(has1)}{int(has2)}",
                       "dtype": dname,
                       "variant": A._plan(dtype, t2, t1, dh,
                                          both=True).variant,
                       "max_abs_err": err, "tol": tol, "library_ms": None,
                       "library_device_ms": None, **_timings(calls)}
                # six inputs read once; ctx1, ctx2 written (shapes of q2, q1)
                nbytes = (sum(x.numel() for x in xs) + xs[0].numel()
                          + xs[3].numel()) * xs[0].element_size() \
                    + sum(0 if m is None else m.numel() for m in (v1, v2))
                rec.update(_bound(nbytes, 2 * 4.0 * B * h * t1 * t2 * dh,
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


def build_model(seed: int = 0):
    from gpv_tpu_torch.models.gpv import GPV
    from gpv_tpu_torch.weights import init_random
    return init_random(GPV(vocab_size=VOCAB), seed)


# the port's kernels by the name each __global__ function has in a trace,
# most specific first: (variant key, name fragment)
PORT_KERNELS = (("K2 tile", "gpv_attn_tile_bi_kernel"),
                ("K1 tile", "gpv_attn_tile_kernel"),
                ("K1 decode", "gpv_attn_decode_kernel"),
                ("fp32", "gpv_attn_fp32"))


def phase_profile(eng, images, queries) -> dict:
    """torch.profiler over one predict: device time by kernel, the port's
    kernels by variant, and the share of the call's wall time in which the
    card ran no kernel. Fails unless K1's Tq >= 2 calls (30) ran on the
    tile kernel, its decode-step calls (6 a step) on the decode kernel and
    K2's 3 on the tile kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.predict(images, queries)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
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
    steps = eng.last_decode_steps
    want = {"K2 tile": 3, "K1 tile": 30, "K1 decode": 6 * steps, "fp32": 0}
    got = {k: v["launches"] for k, v in port.items()}
    if got != want:
        fail(f"profiled kernel launches {got} != expected {want}")
    return {"phase": "profile", "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "ms_by_group": by_group, "port_kernels": port,
            "top_kernels": [{"ms": ms, "count": n, "name": name[:90]}
                            for ms, n, name in rows[:15]]}


def phase_slice(model):
    import numpy as np
    import torch
    from gpv_tpu_torch.engine import GPVEngine
    from gpv_tpu_torch.ops.attention import fused_attention, fused_biattention
    from gpv_tpu_torch.text.vocab import AnswerVocab
    from gpv_tpu_torch.text.wordpiece import WordPieceTokenizer

    t0 = time.perf_counter()
    eng = GPVEngine(model, AnswerVocab.debug(size=VOCAB),
                    WordPieceTokenizer.debug(), device="cuda",
                    dtype=torch.bfloat16)
    setup_s = time.perf_counter() - t0
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (B, IMG_H, IMG_W, 3)).astype(np.uint8)
    queries = _queries(B, rng)
    _, qvalid = eng.tokenizer.batch_encode(queries, eng.max_query_len)
    if qvalid.shape != (B, 20) or not (qvalid.sum(1) == QUERY_TOKENS).all():
        fail(f"queries are not {QUERY_TOKENS} tokens: {qvalid.sum(1)}")
    eng.predict(images, queries)          # warm-up (cuDNN plans, allocator)
    torch.cuda.synchronize()

    wrappers = (fused_attention, fused_biattention)
    for w in wrappers:
        w.launches = 0
        w.variant_launches = dict.fromkeys(w.variant_launches, 0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = eng.predict(images, queries)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in wrappers}
    by_variant = {w.__name__: dict(w.variant_launches) for w in wrappers}
    steps = eng.last_decode_steps
    want = {"fused_attention": 30 + 6 * steps, "fused_biattention": 3}
    want_variant = {"fused_attention": {"tile": 30, "decode": 6 * steps,
                                        "fp32": 0},
                    "fused_biattention": {"tile": 3, "fp32": 0}}
    if launches != want or by_variant != want_variant:
        fail(f"launch counts {launches} {by_variant} != expected {want} "
             f"{want_variant} ({steps} decode steps)")

    if len(results) != B:
        fail(f"{len(results)} results for {B} images")
    for r in results:
        boxes, rel = r["boxes"], r["relevance"]
        if boxes.shape != (100, 4) or rel.shape != (100,):
            fail(f"shapes boxes {boxes.shape} relevance {rel.shape}")
        if not (np.isfinite(boxes).all() and (boxes >= 0).all()
                and (boxes <= 1).all()):
            fail("boxes not finite in [0, 1]")
        if not (np.isfinite(rel).all() and (np.diff(rel) <= 0).all()):
            fail("relevance not finite and sorted descending")
        if not isinstance(r["answer"], str):
            fail("answer is not a string")

    n_iter = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_iter):
        eng.predict(images, queries)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rec = {"phase": "slice", "batch": B, "image_hw": [IMG_H, IMG_W],
           "dtype": "bfloat16", "decode_steps": steps,
           "launches": launches, "launches_by_variant": by_variant,
           "engine_setup_s": setup_s,
           "measured_call_s": call_s,
           "images_per_s": B * n_iter / dt,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "answers": [r["answer"] for r in results[:3]]}
    return rec, phase_profile(eng, images, queries)


def phase_e2e(model) -> dict:
    import numpy as np
    import torch
    from gpv_tpu_torch.decode.greedy import greedy_decode
    from gpv_tpu_torch.engine import GPVEngine
    from gpv_tpu_torch.ops.image import normalize_image
    from gpv_tpu_torch.text.vocab import AnswerVocab
    from gpv_tpu_torch.text.wordpiece import WordPieceTokenizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(1)
    images = rng.randint(0, 256, (2, IMG_H, IMG_W, 3)).astype(np.uint8)
    tok = WordPieceTokenizer.debug()
    ids, valid = tok.batch_encode(_queries(2, rng), 20)
    outs = {}
    for device in ("cuda", "cpu"):
        eng = GPVEngine(model, AnswerVocab.debug(size=VOCAB), tok,
                        device=device, dtype=torch.float32)
        dev = eng.device
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
            "logits0": logits[:, 0].cpu(), "tokens": tokens.cpu()}
        del eng
    c, p = outs["cuda"], outs["cpu"]
    rec = {"phase": "e2e", "images": 2, "dtype": "float32"}
    for key, tol in (("boxes", 1e-3), ("relevance", 1e-3),
                     ("logits0", 2e-3)):
        err = (c[key] - p[key]).abs().max().item()
        rec[f"{key}_max_abs_err"], rec[f"{key}_tol"] = err, tol
        if not err <= tol:
            fail(f"e2e {key}: max abs err {err} > {tol}")
    rec["greedy_token_agreement"] = (c["tokens"] == p["tokens"]).float() \
        .mean().item()
    return rec


def kernels_line(kern: dict, sl: dict) -> dict:
    """One entry per kernel of the path, for one predict of the slice run:
    each main-path bf16 shape's numbers times its launches in that run,
    summed over the shapes that kernel serves."""
    keys = ("ms", "device_ms", "plain_ms", "plain_device_ms", "library_ms",
            "library_device_ms", "bound_ms", "bytes_ms", "ops_ms")

    def per_predict(recs, counts):
        tot = {k: 0.0 for k in keys}
        for r in recs:
            for k in keys:
                tot[k] += counts.get(r["case"], 0) * (r[k] or 0.0)
        tot["bound_by"] = ("bytes" if tot.pop("bytes_ms") >= tot.pop("ops_ms")
                           else "operations")
        tot["max_abs_err"] = max(r["max_abs_err"] for r in recs)
        return tot

    steps = sl["decode_steps"]
    counts = {c[0]: c[-1] for c in k1_cases(steps)}
    bf16 = [r for r in kern["K1"] if r["dtype"] == "bfloat16"]
    k2_bf16 = [r for r in kern["K2"] if r["dtype"] == "bfloat16"]
    k2 = per_predict(k2_bf16, {"masks_10": 3})
    k2["library_ms"] = k2["library_device_ms"] = None  # no single call
    main = next(r for r in k2_bf16 if r["case"] == "masks_10")
    k2["sdpa_two_calls_ms"] = 3 * main["sdpa_two_calls_ms"]
    k2["sdpa_two_calls_device_ms"] = 3 * main["sdpa_two_calls_device_ms"]
    per = f"one predict: B={B}, bf16, {steps} decode steps"
    variants = sl["launches_by_variant"]
    line = []
    for variant, source in (("tile", "attention_tile.cu"),
                            ("decode", "attention_decode.cu")):
        recs = [r for r in bf16 if r["variant"] == variant]
        line.append({"name": f"fused_attention[{variant}]", "route": "cuda",
                     "source": f"gpv_tpu_torch/csrc/{source}",
                     "replaces": "gpv_tpu/ops/attention.py:55",
                     "launches": variants["fused_attention"][variant],
                     **per_predict(recs, counts), "per": per})
    line.append({"name": "fused_biattention[tile]", "route": "cuda",
                 "source": "gpv_tpu_torch/csrc/attention_tile.cu",
                 "replaces": "gpv_tpu/ops/attention.py:147",
                 "launches": variants["fused_biattention"]["tile"],
                 **k2, "per": per})
    return {"kernels": line}


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
    model = build_model(seed=0)
    sl, prof = phase_slice(model)
    for rec in (sl, prof):
        records.append(rec)
        emit(rec)
    records.append(phase_e2e(model))
    emit(records[-1])
    line = kernels_line(records[2], sl)
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
