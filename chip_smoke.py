#!/usr/bin/env python3
"""Drive the PyTorch port (`gpv_tpu_torch`) on one CUDA card, end to end.

    python3 chip_smoke.py [--report PATH]

Run from the root of a checkout. Phases, each printing one JSON line:
  device   the card, and its name and power limit as nvidia-smi gives them;
  build    nvcc builds every kernel source of gpv_tpu_torch/csrc (sm_90a);
  kernels  K1 (fused_attention) and K2 (fused_biattention) against their
           plain PyTorch versions at every main-path shape, fp32 (TF32 off)
           and bf16, timed beside the plain version and SDPA;
  slice    GPVEngine.predict at the released width (B=20 uint8 480x640,
           12-token queries, bf16, BN folded, seeded random weights), with
           the kernels' launch counts read around that one call;
  profile  torch.profiler over one more predict: device time by kernel
           and the device's idle share;
  e2e      the same weights in fp32 on the card (kernels) and on the CPU
           (plain versions), on 2 images: boxes, relevance, first-step
           logits, greedy tokens.
Then one `kernels` line for both kernels, and last
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


def phase_build() -> dict:
    from gpv_tpu_torch.ops import _cuda
    seconds = _cuda.build_all()
    ptxas = [ln.strip() for name in _cuda.SOURCES
             for ln in _cuda.build_log(name).splitlines()
             if "Used" in ln or "spill" in ln]
    return {"phase": "build", "sources": list(_cuda.SOURCES),
            "seconds": seconds, "ptxas": ptxas}


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
                rec = {"case": name, "dtype": dname, "max_abs_err": err,
                       "tol": TOL[dname] * scale,
                       "ms": time_ms(lambda: A.fused_attention(
                           q, k, v, kv, causal)),
                       "plain_ms": time_ms(lambda: A.attend_plain(
                           q, k, v, kv, causal)),
                       "library_ms": time_ms(
                           lambda: F.scaled_dot_product_attention(
                               qt, kt, vt, attn_mask=sdpa_mask,
                               is_causal=causal))}
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
                rec = {"case": f"masks_{int(has1)}{int(has2)}",
                       "dtype": dname, "max_abs_err": err, "tol": tol,
                       "ms": time_ms(lambda: A.fused_biattention(
                           *xs, v1, v2)),
                       "plain_ms": time_ms(lambda: A.biattend_plain(
                           *xs, v1, v2)),
                       "library_ms": None,
                       "sdpa_two_calls_ms": time_ms(sdpa_pair)}
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


def phase_profile(eng, images, queries) -> dict:
    """torch.profiler over one predict: device time by kernel, and the
    share of the call's wall time in which the card ran no kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.predict(images, queries)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    from torch.autograd import DeviceType
    rows = []  # device-side events only: kernels and copies
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    groups = (("port_attention_kernels", ("attention_kernel",)),
              ("conv", ("conv", "cudnn", "fprop", "implicit")),
              ("gemm", ("gemm", "nvjet", "cutlass", "xmma")),
              ("memcpy", ("memcpy",)))
    by_group = {g: 0.0 for g, _ in groups}
    by_group["other"] = 0.0
    for ms, _, name in rows:
        low = name.lower()
        group = next((g for g, words in groups
                      if any(w in low for w in words)), "other")
        by_group[group] += ms
    return {"phase": "profile", "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "ms_by_group": by_group,
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

    fused_attention.launches = fused_biattention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = eng.predict(images, queries)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    launches = {"fused_attention": fused_attention.launches,
                "fused_biattention": fused_biattention.launches}
    steps = eng.last_decode_steps
    want = {"fused_attention": 30 + 6 * steps, "fused_biattention": 3}
    if launches != want:
        fail(f"launch counts {launches} != expected {want} "
             f"({steps} decode steps)")

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
           "launches": launches, "engine_setup_s": setup_s,
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
    """One entry per kernel, for one predict of the slice run: each main-path
    bf16 shape's numbers times its launches in that run, summed."""
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms",
            "ops_ms")

    def per_predict(recs, counts):
        tot = {k: 0.0 for k in keys}
        for r in recs:
            for k in keys:
                tot[k] += counts.get(r["case"], 0) * (r[k] or 0.0)
        tot["bound_by"] = ("bytes" if tot.pop("bytes_ms") >= tot.pop("ops_ms")
                           else "operations")
        return tot

    steps = sl["decode_steps"]
    counts = {c[0]: c[-1] for c in k1_cases(steps)}
    bf16 = lambda recs: [r for r in recs  # noqa: E731
                         if r["dtype"] == "bfloat16"]
    k2 = per_predict(bf16(kern["K2"]), {"masks_10": 3})
    k2["library_ms"] = None  # no single PyTorch call does both directions
    k2["sdpa_two_calls_ms"] = 3 * next(
        r["sdpa_two_calls_ms"] for r in bf16(kern["K2"])
        if r["case"] == "masks_10")

    def errs(recs):
        return {"max_abs_err": max(r["max_abs_err"] for r in recs),
                "max_abs_err_fp32": max(r["max_abs_err"] for r in recs
                                        if r["dtype"] == "float32")}
    per = f"one predict: B={B}, bf16, {steps} decode steps"
    return {"kernels": [
        {"name": "fused_attention", "route": "cuda",
         "source": "gpv_tpu_torch/csrc/attention.cu",
         "replaces": "gpv_tpu/ops/attention.py:55",
         "launches": sl["launches"]["fused_attention"],
         **errs(kern["K1"]), **per_predict(bf16(kern["K1"]), counts),
         "per": per},
        {"name": "fused_biattention", "route": "cuda",
         "source": "gpv_tpu_torch/csrc/attention.cu",
         "replaces": "gpv_tpu/ops/attention.py:147",
         "launches": sl["launches"]["fused_biattention"],
         **errs(kern["K2"]), **k2, "per": per}]}


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
