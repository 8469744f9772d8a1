"""Open-loop serving: single requests (one image, one query) arrive at a
fixed rate into the program's `GPVServer`, which coalesces them into
padded batches, whatever the server's state.

Arrivals are a Poisson process at `rate_per_s`, conditioned on its count:
`round(rate * seconds)` arrival times drawn uniformly over the window and
sorted, so every seed offers the same number of requests in another
order. Each request is timed from when it was due to when its answer is
resolved; how late the generator submitted goes to standard error. The
server runs with the configuration's `serve` node (batch size, buckets,
coalescing window, workers, warm-up of every bucket at the traffic's
image size).

Traffic parameters: `rate_per_s`, `image_hw`, `pool_batches` (pool
images, in batches of 20), `templates`, `objects`, `max_query_len`,
`check_rows`, `profile_s`, `drain_s` (how long answers may come after the
window), and for `sweep` its rates.

End-to-end: `request_p95_ms`, `peak_mem_gib`, `setup_s`.
"""
from __future__ import annotations

import time

import numpy as np

from gpvbench import build, judge
from gpvbench.trace import (Profile, Spans, TraceData, breakdown,
                            clock_offset, profiler, read_profile)

POOL_BATCH = 20


def make_server(ctx, eng):
    from gpv_tpu_torch.serve import GPVServer
    s = ctx.config["serve"]
    t = time.perf_counter()
    server = GPVServer(eng, batch_size=int(s["batch_size"]),
                       max_wait_ms=float(s["max_wait_ms"]),
                       num_workers=int(s["num_workers"]),
                       bucket_sizes=s["bucket_sizes"],
                       warmup=(tuple(ctx.traffic["image_hw"])
                               if s["warmup"] else None))
    ctx.split("warmup", time.perf_counter() - t)
    return server


def offer(ctx, server, pool, rate: float, seconds: float, seed_stream: int,
          on_profile=None):
    """Offer `round(rate * seconds)` requests over `seconds`; returns
    (records, lateness seconds, window start). A record is [image index,
    query, due, done or None, future]. `on_profile(start|stop)` is called
    at a third of the window and `profile_s` later."""
    rng = np.random.default_rng(build.seed_of(ctx.seed, seed_stream))
    n = max(1, int(round(rate * seconds)))
    due = np.sort(rng.uniform(0.0, seconds, n))
    n_img = pool.images.shape[0] * pool.images.shape[1]
    picks = rng.integers(n_img, size=n)
    queries = pool.queries(rng, n)
    records, late = [], []
    prof_at = (seconds / 3.0, seconds / 3.0 + min(
        float(ctx.traffic["profile_s"]), seconds / 3.0))
    prof_state = 0
    t0 = time.perf_counter()
    for i in range(n):
        at = t0 + due[i]
        while True:   # one sleep to the next due time or profiler mark
            now = time.perf_counter()
            if on_profile is not None and prof_state < 2 \
                    and now - t0 >= prof_at[prof_state]:
                on_profile(("start", "stop")[prof_state])
                prof_state += 1
                continue
            if now >= at:
                break
            wake = at if on_profile is None or prof_state >= 2 else min(
                at, t0 + prof_at[prof_state])
            time.sleep(max(wake - now, 0.0))
        k = int(picks[i])
        rec = [k, queries[i], at, None, None]
        fut = server.submit(pool.images[k // POOL_BATCH][k % POOL_BATCH],
                            queries[i])
        late.append(time.perf_counter() - at)

        def done(_, rec=rec):
            rec[3] = time.perf_counter()
        rec[4] = fut
        fut.add_done_callback(done)
        records.append(rec)
    while on_profile is not None and prof_state < 2:
        on_profile(("start", "stop")[prof_state])
        prof_state += 1
    return records, late, t0


def settle(records, drain_s: float) -> None:
    """Wait until every answer is in, at most `drain_s` past the window."""
    deadline = time.perf_counter() + drain_s
    for rec in records:
        rest = deadline - time.perf_counter()
        try:
            rec[4].result(timeout=max(rest, 0.001))
        except Exception:  # failed or late: judged from the record
            pass


def latencies(records) -> list:
    return [r[3] - r[2] for r in records
            if r[3] is not None and r[4].done() and not r[4].cancelled()
            and r[4].exception() is None]


def run(ctx) -> dict:
    import torch
    tr = ctx.traffic
    dev = torch.device(ctx.device)
    eng = build.make_engine(ctx)
    pool = build.Pool(ctx, int(tr["pool_batches"]), POOL_BATCH)
    spans = Spans()
    prof, marks = None, {}
    if ctx.trace:
        eng.predict = spans.wrap("predict", eng.predict)
        # the profiler starts before the server's worker threads exist and
        # stops once they have ended (started or stopped beside running
        # workers it has crashed the process); the window read is the
        # stretch `offer` marks
        prof = profiler(dev.type)
        prof.__enter__()
    server = make_server(ctx, eng)

    def on_profile(what):
        marks[what] = time.perf_counter()

    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t_first = time.perf_counter()
    ctx.log(f"gpvbench: set-up {t_first - ctx.t_start:.3f} s "
            + " ".join(f"{k} {v:.3f}" for k, v in ctx.setup.items()))
    records, late, t0 = offer(ctx, server, pool, float(tr["rate_per_s"]),
                              ctx.seconds, 2,
                              on_profile if ctx.trace else None)
    settle(records, float(tr["drain_s"]))
    stats = server.stats()
    server.close(drain=False)
    if prof is not None:
        prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    lat = latencies(records)
    n = len(records)
    failed = n - len(lat)
    # a request never answered counts as missing any limit
    p95 = (1e3 * float(np.percentile(lat + [float("inf")] * failed, 95))
           if lat else float("inf"))
    ctx.log(f"gpvbench: {n} requests at {tr['rate_per_s']}/s over "
            f"{ctx.seconds} s, {failed} unanswered; latency ms median "
            f"{1e3 * float(np.median(lat)):.3f} p95 {p95:.3f}; generator "
            f"late ms median {1e3 * float(np.median(late)):.3f} max "
            f"{1e3 * max(late):.3f}; server {stats}")
    result = {"metrics": {"setup_s": t_first - ctx.t_start,
                          "request_p95_ms": p95,
                          "peak_mem_gib": peak / 2 ** 30},
              "attempted": n, "failed": failed, "trace": None}
    profile = None
    if ctx.trace:
        profile = Profile([e for e in read_profile(prof, clock_offset())
                           if e.end > marks["start"]
                           and e.start < marks["stop"]],
                          marks["start"], marks["stop"])
        events = profile.events
        result["breakdown"] = breakdown(events, spans, profile.t0,
                                        profile.t1)
        result["trace"] = TraceData(ctx.model, spans, profile,
                                    {"server": stats})
    result["device"] = (build.device_info(peak, profile)
                        if dev.type == "cuda" else
                        {"platform": "cpu", "kind": "cpu", "count": 1,
                         "memory_peak_bytes": 0})

    words = list(eng.vocab.words)
    del eng, server
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    answered = [r for r in records if r[3] is not None
                and r[4].exception() is None]
    pick = np.random.default_rng(build.seed_of(ctx.seed, 4)).choice(
        len(answered), min(int(tr["check_rows"]), len(answered)),
        replace=False)
    rows = []
    for i in sorted(pick):
        k, q, _, _, fut = answered[i]
        out = fut.result()
        rows.append({"image": pool.images[k // POOL_BATCH][k % POOL_BATCH],
                     "query": q, "answer": out["answer"],
                     "boxes": out["boxes"], "relevance": out["relevance"]})
    result["readings"] = judge.readings(ctx, rows, words)
    if failed:
        result["readings"]["token_gap"] = float("inf")
    return result


def sweep(ctx, rates, seconds: float) -> list:
    """The knee: each offered rate for `seconds` on one warm server; per
    rate the p95, the answers a second, and whether the backlog grew (the
    last third's median latency over the first third's)."""
    eng = build.make_engine(ctx)
    pool = build.Pool(ctx, int(ctx.traffic["pool_batches"]), POOL_BATCH)
    server = make_server(ctx, eng)
    out = []
    for j, rate in enumerate(rates):
        records, late, t0 = offer(ctx, server, pool, rate, seconds, 10 + j)
        settle(records, float(ctx.traffic["drain_s"]))
        lat = latencies(records)
        thirds = np.array_split(np.array([r[3] - r[2] if r[3] else np.inf
                                          for r in records]), 3)
        done = [r[3] for r in records if r[3] is not None]
        out.append({"rate": rate, "n": len(records),
                    "answered": len(lat),
                    "p50_ms": 1e3 * float(np.median(lat)),
                    "p95_ms": 1e3 * float(np.percentile(lat, 95)),
                    "answers_per_s": len(done) / (max(done) - t0),
                    "growth": float(np.median(thirds[2])
                                    / np.median(thirds[0])),
                    "late_max_ms": 1e3 * max(late)})
        ctx.log(f"gpvbench sweep: {out[-1]}")
    server.close(drain=False)
    return out
