"""On the card: the program's spans and the device trace share one clock
(a span around a spinning kernel encloses the kernel's device interval as
`trace.read_profile` maps it, and starts with it), and spans add no
host-device synchronisation (a greedy predict and a train step of the
cells, at tiny widths in bf16, raise the same synchronising operations
with spans on as off). Skips without a card.

    python -m pytest -m cuda -s gpvbench/tests/test_gpvbench_spans_card.py
"""
from __future__ import annotations

import json
import time
import warnings
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from gpvbench import build, run
from gpvbench.tests.tiny import tiny

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
SPIN_CYCLES = 20_000_000    # about 10 ms at the H100's clock


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture
def spans():
    from gpv_tpu_torch.utils import profiling
    profiling.disable()
    profiling.drain()
    yield profiling
    profiling.disable()
    profiling.drain()


@pytest.mark.cuda
def test_spans_and_device_events_share_one_clock(card, spans):
    import torch
    from gpvbench.trace import (clock_offset, profiler, read_profile,
                                warm_profiler)
    warm_profiler("cuda")
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    spans.drain()
    with profiler("cuda") as prof:
        with spans.span("clock"):
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
    events = read_profile(prof, clock_offset())
    (rec,) = [r for r in spans.drain() if r.name == "clock"]
    k = max(events, key=lambda e: e.end - e.start)
    start, end = rec.start_ns * 1e-9, rec.end_ns * 1e-9
    print(f"clock: kernel {k.name!r} {1e3 * (k.end - k.start):.3f} ms; "
          f"starts {1e6 * (k.start - start):.1f} us after the span, ends "
          f"{1e6 * (end - k.end):.1f} us before its end")
    assert k.end - k.start > 1e-3
    assert start <= k.start and k.end <= end
    assert k.start - start < 0.5e-3


def _ctx(cell):
    ctx = tiny(run.make_ctx(MAN, cell, 2 ** 31 + 5, 1.0, False, "cuda",
                            time.perf_counter()))
    ctx.dtype = "bfloat16"
    ctx.log = lambda line: None
    return ctx


def _syncs(fn) -> Counter:
    """The synchronising CUDA operations `fn` runs, by call site."""
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return Counter(f"{Path(w.filename).name}:{w.lineno}" for w in caught
                   if "synchroniz" in str(w.message))


def _same_syncs(name, fn, spans):
    for _ in range(2):   # builds, plans, pools and lazy state first
        fn()
    # a process's first count has held one sync more, in
    # torch/cuda/__init__.py, spans on or off: it is not compared
    first = _syncs(fn)
    off = _syncs(fn)
    spans.enable()
    on = _syncs(fn)
    spans.disable()
    recorded = spans.drain()
    again = _syncs(fn)
    print(f"{name}: {sum(off.values())} syncs {dict(off)}; first count "
          f"{dict(first - off)} more")
    assert recorded and off and on == off == again


@pytest.mark.cuda
def test_spans_add_no_sync_to_a_predict(card, spans):
    ctx = _ctx("predict-greedy-r50")
    eng = build.make_engine(ctx)
    B = int(ctx.traffic["batch"])
    pool = build.Pool(ctx, 1, B)
    queries = pool.queries(np.random.default_rng(0), B)
    _same_syncs("predict", lambda: eng.predict(pool.images[0], queries),
                spans)


@pytest.mark.cuda
def test_spans_add_no_sync_to_a_train_step(card, spans):
    import torch
    from gpv_tpu_torch.datasets.loader import Collator
    from gpv_tpu_torch.losses.criterion import LossConfig
    from gpv_tpu_torch.models.gpv import build_gpv
    from gpv_tpu_torch.parallel.train_step import TrainState, make_train_step
    from gpv_tpu_torch.text.vocab import AnswerVocab
    from gpv_tpu_torch.text.wordpiece import WordPieceTokenizer
    from gpv_tpu_torch.train.optimizer import build_optimizer

    ctx = _ctx("train-4task-r50")
    conf, tr = ctx.config, ctx.traffic
    tr["batches"] = 1
    V = int(conf["vocab_size"])
    with torch.device("cuda"):
        model = build_gpv(build.node(ctx.model), V)
    model.load_state_dict(build.seeded_weights(ctx), strict=True)
    step = make_train_step(
        model, LossConfig.from_config(build.node(conf["losses"])),
        clip_max_norm=float(conf["training"]["clip_max_norm"]),
        dtype=torch.bfloat16)
    optimizer, scheduler = build_optimizer(
        build.node(conf["training"]), int(conf["steps_per_epoch"]), model)
    state = TrainState(model, optimizer, scheduler)
    pool = build.Pool(ctx, 1, 4 * int(tr["per_task"]))
    items = ctx.driver().make_items(ctx, pool)[0]
    batch = Collator(AnswerVocab(build.answer_words(V)),
                     WordPieceTokenizer(build.bert_words(tr)),
                     max_text_len=int(ctx.model["max_text_len"]),
                     max_query_len=int(tr["max_query_len"]),
                     max_target_boxes=int(ctx.model["max_target_boxes"]),
                     dedup_queries=True)(items)
    _same_syncs("train step", lambda: step(state, batch), spans)
