"""Closed-loop batched prediction: one caller sends `GPVEngine.predict`
requests of `batch` images and queries back to back, each as soon as the
previous answer is on the host, for the whole window.

Traffic parameters (`traffic/<name>.json`): `batch`, `image_hw`,
`pool_batches` (distinct image batches made in set-up, drawn in a seeded
order), `templates` and `objects` (the queries), `max_query_len` (the
padded query length), `check_rows` (answers the reference checks),
`profile_s` (the traced run's profiler window), `warmup_calls`.

A traced run's profile counts hold what the per-layer readers take from
the configuration's family (`family.counts`): `flops_per_call`, and
`bound_ms[kind]`, the least device ms of each kernel kind's work items
(`predict_work`) summed over the profiled calls; and the program's
launches of each kind with `counters` in `kernels/` (`launches[kind]`),
which the trace has to hold (`trace.launch_gaps`).

End-to-end: `predict_images_per_s` (images answered over the window, from
its start to the end of the call that crosses its end), `request_p95_ms`
(95th percentile of every call's latency, a call being one request),
`peak_mem_gib` (the allocator's peak over the window), `setup_s` (process
start to the first timed call).
"""
from __future__ import annotations

import importlib
import time

import numpy as np

from gpvbench import build, family, judge
from gpvbench.flops import launches_bound_ms
from gpvbench.trace import (Profile, Spans, TraceData, breakdown,
                            clock_offset, counters, launch_gaps, profiler,
                            read_profile, settle, warm_profiler)

PROFILE_TRIES = 5      # profiler windows a traced run may take


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _counters() -> dict:
    """{kind: {function name: program function}} of the `counters` that
    `kernels/<kind>-*.json` name."""
    out = {}
    for kind, names in counters().items():
        out[kind] = {}
        for name in names:
            module, fn = name.split(":")
            out[kind][fn] = getattr(importlib.import_module(module), fn)
    return out


def _counted_launches(fns: dict) -> dict:
    """{kind: {"<function>.<variant>": launches}} as the program's counters
    read now."""
    return {kind: {f"{name}.{v}": n for name, fn in by_name.items()
                   for v, n in fn.variant_launches.items()}
            for kind, by_name in fns.items()}


def _window_work(counts, model: dict, B: int, H: int, W: int, L: int,
                 steps: list) -> dict:
    """{kind: the least device ms of the work items of the calls that
    decoded `steps`}."""
    out = {}
    for s in steps:
        for kind, items in counts.predict_work(model, B, H, W, L, s).items():
            out[kind] = out.get(kind, 0) + launches_bound_ms(items)
    return out


def run(ctx) -> dict:
    import torch
    tr = ctx.traffic
    dev = torch.device(ctx.device)
    B, (H, W) = int(tr["batch"]), tr["image_hw"]
    eng = build.make_engine(ctx)
    pool = build.Pool(ctx, int(tr["pool_batches"]), B)
    rng = np.random.default_rng(build.seed_of(ctx.seed, 2))
    counted = _counters()

    def draw(r):
        return int(r.integers(len(pool.images))), pool.queries(r, B)

    t = time.perf_counter()
    warm = np.random.default_rng(build.seed_of(ctx.seed, 3))
    for _ in range(int(tr["warmup_calls"])):
        k, qs = draw(warm)
        eng.predict(pool.images[k], qs)
    if ctx.trace:
        warm_profiler(dev.type)
    _sync(dev)
    ctx.split("warmup", time.perf_counter() - t)

    spans = Spans(sync=(lambda: _sync(dev)))
    predict = eng.predict
    if ctx.trace:
        import gpv_tpu_torch.engine as engine_mod
        decode = engine_mod.greedy_decode
        eng.model.encode = spans.wrap("encode", eng.model.encode)
        engine_mod.greedy_decode = spans.wrap("decode", decode)
        eng.tokenizer.batch_encode = spans.wrap("tokenize",
                                                eng.tokenizer.batch_encode)
        predict = spans.wrap("predict", eng.predict)

    log = []           # (pool batch, queries, outputs)
    lat, steps, ends = [], [], []
    prof = profile = None
    p_tries = 0
    prof_from = ctx.seconds / 3.0
    prof_len = min(float(tr["profile_s"]), ctx.seconds / 3.0)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ctx.log(f"gpvbench: set-up {t0 - ctx.t_start:.3f} s "
            + " ".join(f"{k} {v:.3f}" for k, v in ctx.setup.items()))
    end = t0 + ctx.seconds
    while True:
        k, qs = draw(rng)
        now = time.perf_counter()
        if ctx.trace and prof is None and profile is None \
                and now - t0 >= prof_from:
            prof = profiler(dev.type)
            prof.__enter__()
            _sync(dev)
            p_t0, p_calls, p_launch = time.perf_counter(), 0, \
                _counted_launches(counted)
            p_steps = []
            p_tries += 1
        t_due = time.perf_counter()
        out = predict(pool.images[k], qs)
        t_done = time.perf_counter()
        lat.append(t_done - t_due)
        ends.append(t_done - t0)
        steps.append(eng.last_decode_steps)
        log.append((k, qs, out))
        if prof is not None:
            p_calls += 1
            p_steps.append(eng.last_decode_steps)
            if t_done - p_t0 >= prof_len:
                _sync(dev)
                p_t1 = time.perf_counter()
                launches = {
                    kind: {v: n - p_launch[kind].get(v, 0)
                           for v, n in by_v.items()}
                    for kind, by_v in _counted_launches(counted).items()}
                settle(dev.type)
                prof.__exit__(None, None, None)
                profile = Profile(read_profile(prof, clock_offset()), p_t0,
                                  p_t1, {"calls": p_calls,
                                         "images": p_calls * B,
                                         "steps": p_steps,
                                         "launches": launches})
                prof = None
                # a window whose trace lost records is profiled again
                gaps = [f"{kind}: {gap}" for kind, n in launches.items()
                        for gap in launch_gaps(profile.events, n, kind)]
                if gaps and p_tries < PROFILE_TRIES:
                    ctx.log(f"gpvbench: profiler window {p_tries} lost "
                            f"records ({'; '.join(gaps)}); profiling again")
                    profile = None
        # a traced run ends once its profiler window has closed
        if t_done >= end and (profile is not None or not ctx.trace):
            break
    window = t_done - t0
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    n = len(lat)
    thirds = [min(int(3 * e / window), 2) for e in ends]
    metrics = {
        "setup_s": t0 - ctx.t_start,
        "predict_images_per_s": n * B / window,
        "request_p95_ms": 1e3 * float(np.percentile(lat, 95)),
        "peak_mem_gib": peak / 2 ** 30}
    ctx.log(f"gpvbench: {n} calls of {B} in {window:.3f} s; latency ms "
            f"median {1e3 * float(np.median(lat)):.3f} p95 "
            f"{metrics['request_p95_ms']:.3f} max {1e3 * max(lat):.3f}; "
            f"decode steps {min(steps)}-{max(steps)}; images/s by third "
            + " ".join(f"{B * thirds.count(i) * 3 / window:.1f}"
                       for i in range(3)))
    if ctx.trace:
        engine_mod.greedy_decode = decode
    trace = None
    result = {"metrics": metrics, "attempted": n, "failed": 0}
    if ctx.trace:
        result["breakdown"] = breakdown(profile.events, spans, profile.t0,
                                        profile.t1)
        counts = family.counts(ctx.config)
        L = int(tr["max_query_len"])
        profile.counts["flops_per_call"] = counts.predict_flops(
            ctx.model, int(ctx.config["vocab_size"]), B, H, W, L,
            int(np.mean(profile.counts["steps"])))
        profile.counts["bound_ms"] = _window_work(
            counts, ctx.model, B, H, W, L, profile.counts["steps"])
        trace = TraceData(ctx.model, spans, profile)
    result["trace"] = trace
    if dev.type == "cuda":
        result["device"] = build.device_info(peak, profile)
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                            "memory_peak_bytes": 0}

    # the check: a sample of the window's answers against the reference,
    # once the program's state is freed
    words = list(eng.vocab.words)
    del eng, predict
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    pick = np.random.default_rng(build.seed_of(ctx.seed, 4)).choice(
        n * B, min(int(tr["check_rows"]), n * B), replace=False)
    rows = []
    for i in sorted(pick):
        k, qs, out = log[i // B]
        r = out[i % B]
        rows.append({"image": pool.images[k][i % B], "query": qs[i % B],
                     "answer": r["answer"], "boxes": r["boxes"],
                     "relevance": r["relevance"]})
    t = time.perf_counter()
    result["readings"] = judge.readings(ctx, rows, words)
    ctx.log(f"gpvbench: reference over {len(rows)} rows "
            f"{time.perf_counter() - t:.3f} s")
    return result
