"""Joint four-task training: the program's train step
(`parallel/train_step.py` `make_train_step`: upload, frozen BERT over the
batch's unique queries, the bf16 autocast forward, the criterion with the
Hungarian matching, the backward, the clip, fp32 AdamW) driven over a
few distinct batches in turn for the whole window.

Traffic parameters (`traffic/<name>.json`): `per_task` samples of each
task a batch, `batches` distinct batches made in set-up, `image_hw`,
`templates` by task, `objects`, the answer and box sizes (`caption_words`,
`vqa_words`, `box_counts`: fixed lists, shuffled by the seed, so every
seed makes the same work), `max_query_len`, `checked_steps`,
`start_update` (the schedule resumes there: the first updates of a run
move the weights by rounding alone), `profile_s`.

Set-up builds one train state, drives it through `checked_steps` steps on
distinct batches, then one step on each batch not yet run, and hands the
same state to the window. What the check reads of the checked steps is
what the step returns (its losses) and the optimizer's state (the first
gradient, the parameters). The configuration's dropout rates are 0
(`judge.train_readings`): the masks are draws the reference cannot see. End-to-end: `train_images_per_s` (images of the
steps run over the window, from its start to the end of the step that
crosses its end), `peak_mem_gib`, `setup_s`.
"""
from __future__ import annotations

import time

import numpy as np

from gpvbench import build, family, judge
from gpvbench.trace import (Profile, Spans, TraceData, breakdown,
                            clock_offset, profiler, read_profile,
                            warm_profiler)

def make_items(ctx, pool) -> list:
    """`batches` lists of raw items (query, answer, boxes, task, image):
    captioning and classification share a few prompts, VQA questions and
    localization categories are all distinct, so every batch has the same
    number of unique queries."""
    tr = ctx.traffic
    per = int(tr["per_task"])
    for key in ("caption_words", "vqa_words", "box_counts"):
        if len(tr[key]) != per:
            raise ValueError(f"{key}: {len(tr[key])} sizes for {per} "
                             "samples a task")
    rng = np.random.default_rng(build.seed_of(ctx.seed, 6))
    words = build.answer_words(int(ctx.config["vocab_size"]))[:-4]
    objs, tmpl = tr["objects"], tr["templates"]
    out = []
    for b in range(int(tr["batches"])):
        items = []
        for i, n in enumerate(rng.permutation(tr["caption_words"])):
            items.append({"task": "CocoCaptioning",
                          "query": tmpl["CocoCaptioning"][
                              i % len(tmpl["CocoCaptioning"])],
                          "answer": " ".join(rng.choice(words, n))})
        pairs = rng.choice(len(tmpl["CocoVqa"]) * len(objs) ** 2, per * 4,
                           replace=False)
        seen = []
        for p in pairs:
            t, a, c = p // len(objs) ** 2, (p // len(objs)) % len(objs), \
                p % len(objs)
            if a != c:
                seen.append((t, a, c))
        for (t, a, c), n in zip(seen[:per],
                                rng.permutation(tr["vqa_words"])):
            items.append({"task": "CocoVqa",
                          "query": tmpl["CocoVqa"][t].format(objs[a],
                                                             objs[c]),
                          "answer": " ".join(rng.choice(words, n))})
        for _ in range(per):
            items.append({"task": "CocoClassification",
                          "query": tmpl["CocoClassification"][0],
                          "answer": str(rng.choice(words))})
        cats = rng.choice(len(objs), per, replace=False)
        for c, n in zip(cats, rng.permutation(tr["box_counts"])):
            wh = rng.uniform(0.05, 0.5, (n, 2))
            cxy = rng.uniform(wh / 2, 1 - wh / 2)
            items.append({"task": "CocoDetection",
                          "query": tmpl["CocoDetection"][0].format(objs[c]),
                          "boxes": np.concatenate([cxy, wh], 1).astype(
                              np.float32)})
        order = rng.permutation(len(items))
        items = [items[i] for i in order]
        for i, it in enumerate(items):
            it["image"] = pool.images[b][i]
        out.append(items)
    return out


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def run(ctx) -> dict:
    import torch
    from gpv_tpu_torch.datasets.loader import Collator
    from gpv_tpu_torch.losses.criterion import LossConfig
    from gpv_tpu_torch.models.gpv import build_gpv
    from gpv_tpu_torch.parallel.train_step import TrainState, make_train_step
    from gpv_tpu_torch.text.vocab import AnswerVocab
    from gpv_tpu_torch.text.wordpiece import WordPieceTokenizer
    from gpv_tpu_torch.train.optimizer import build_optimizer, make_schedule

    tr, conf = ctx.traffic, ctx.config
    training = conf["training"]
    dev = torch.device(ctx.device)
    V = int(conf["vocab_size"])
    t = time.perf_counter()
    weights = build.seeded_weights(ctx)
    with dev:
        model = build_gpv(build.node(ctx.model), V)
    model.load_state_dict(weights, strict=True)
    del weights
    ctx.split("weights", time.perf_counter() - t)
    t = time.perf_counter()
    step = make_train_step(
        model, LossConfig.from_config(build.node(conf["losses"])),
        clip_max_norm=float(training["clip_max_norm"]),
        grad_accum=int(training["grad_accum_steps"]),
        dtype=getattr(torch, ctx.dtype), seed=build.seed_of(ctx.seed, 5))
    spe = int(conf["steps_per_epoch"])
    optimizer, _ = build_optimizer(build.node(training), spe, model)
    sched, start = make_schedule(build.node(training), spe), \
        int(tr["start_update"])
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda n: sched(n + start))
    state = TrainState(model, optimizer, scheduler, step=start)
    ctx.split("train_state", time.perf_counter() - t)
    if dev.type == "cuda":
        from gpv_tpu_torch.ops import _cuda
        t = time.perf_counter()
        _cuda.build_all()
        ctx.split("build", time.perf_counter() - t)

    per = int(tr["per_task"])
    B = 4 * per
    pool = build.Pool(ctx, int(tr["batches"]), B)
    t = time.perf_counter()
    items = make_items(ctx, pool)
    collate = Collator(
        AnswerVocab(build.answer_words(V)),
        WordPieceTokenizer(build.bert_words(tr)),
        max_text_len=int(ctx.model["max_text_len"]),
        max_query_len=int(tr["max_query_len"]),
        max_target_boxes=int(ctx.model["max_target_boxes"]),
        dedup_queries=bool(training["query_dedup"]))
    batches = [collate(b) for b in items]
    ctx.split("data", time.perf_counter() - t)

    # the checked steps, then one step on each other batch
    t = time.perf_counter()
    trainable = {n: p for n, p in model.named_parameters()
                 if p.requires_grad}
    prog = {"losses": []}
    for k in range(int(tr["checked_steps"])):
        losses = step(state, batches[k % len(batches)])
        prog["losses"].append({n: float(v) for n, v in losses.items()})
        if k == 0:
            beta1 = optimizer.param_groups[0]["betas"][0]
            # no AdamW state: the step left the parameters as they were
            prog["grad"] = {n: (optimizer.state[p].get(
                "exp_avg", torch.zeros_like(p)) / (1 - beta1)).cpu()
                            for n, p in trainable.items()}
    prog["params"] = {n: p.detach().to("cpu", copy=True)
                      for n, p in trainable.items()}
    for k in range(int(tr["checked_steps"]), len(batches)):
        step(state, batches[k])
    if ctx.trace:
        warm_profiler(dev.type)
    _sync(dev)
    ctx.split("warmup", time.perf_counter() - t)

    spans = Spans(sync=(lambda: _sync(dev)))
    run_step = spans.wrap("step", step) if ctx.trace else step
    prof = profile = None
    prof_from = ctx.seconds / 3.0
    prof_len = min(float(tr["profile_s"]), ctx.seconds / 3.0)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ctx.log(f"gpvbench: set-up {t0 - ctx.t_start:.3f} s "
            + " ".join(f"{k} {v:.3f}" for k, v in ctx.setup.items()))
    end, n, k = t0 + ctx.seconds, 0, len(batches)
    while True:
        if ctx.trace and prof is None and profile is None \
                and time.perf_counter() - t0 >= prof_from:
            prof = profiler(dev.type)
            prof.__enter__()
            _sync(dev)
            p_t0, p_steps = time.perf_counter(), 0
        run_step(state, batches[k % len(batches)])
        k += 1
        n += 1
        if prof is not None:
            p_steps += 1
            if time.perf_counter() - p_t0 >= prof_len:
                _sync(dev)
                p_t1 = time.perf_counter()
                prof.__exit__(None, None, None)
                profile = Profile(read_profile(prof, clock_offset()), p_t0,
                                  p_t1, {"steps": p_steps})
                prof = None
        if time.perf_counter() >= end and \
                (profile is not None or not ctx.trace):
            _sync(dev)
            break
    window = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    metrics = {"setup_s": t0 - ctx.t_start,
               "train_images_per_s": n * B / window,
               "peak_mem_gib": peak / 2 ** 30}
    ctx.log(f"gpvbench: {n} steps of {B} in {window:.3f} s; "
            f"{metrics['train_images_per_s']:.3f} images/s")
    result = {"metrics": metrics, "attempted": n, "failed": 0, "trace": None}
    if ctx.trace:
        U = len(batches[0].get("query_uniq_ids", batches[0]["query_ids"]))
        counts = family.counts(ctx.config)
        profile.counts["flops_per_step"] = counts.train_flops(
            ctx.model, V, B, U, *tr["image_hw"], int(tr["max_query_len"]),
            int(ctx.model["max_text_len"]))
        result["breakdown"] = breakdown(profile.events, spans, profile.t0,
                                        profile.t1)
        result["trace"] = TraceData(ctx.model, spans, profile,
                                    {"batch": B})
    result["device"] = (build.device_info(peak, profile)
                        if dev.type == "cuda" else
                        {"platform": "cpu", "kind": "cpu", "count": 1,
                         "memory_peak_bytes": 0})

    # the check, once the program's state is freed
    del step, state, optimizer, scheduler, model, trainable, run_step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checked = int(tr["checked_steps"])
    t = time.perf_counter()
    result["readings"] = judge.train_readings(ctx, items[:checked], prog)
    ctx.log(f"gpvbench: reference over {checked} steps "
            f"{time.perf_counter() - t:.3f} s")
    return result
