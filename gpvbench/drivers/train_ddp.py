"""Data-parallel joint training on `ranks` cards, GPV-1's released recipe
(4 GPUs, DDP over NCCL, global batch 120): the program's train step
(`parallel/train_step.py` `make_train_step`) under
`DistributedDataParallel`, one process a card, each on its share of
every global batch.

Traffic parameters: those of `drivers/train.py` (whose `make_items` and
`_sync` this driver loads by file), and `ranks`. The global batches are
`make_items`' (seeded; the rows of each shuffled by the seed), and rank r
holds the rows the program's `parallel.mesh.shard_rows` deals it
(`rows`): 30 of 120 at four ranks, a mix of the four tasks, as the
released `DistributedSampler` dealt them. Frozen BERT's query dedup runs
on each rank's own rows.

The driver's process is rank 0, on card 0. It starts ranks 1..N-1, each a
process of its own (`rank_main`), which join it through the program's
`parallel.mesh.initialize_distributed` at tcp://localhost:<a free port>:
the program chooses NCCL, every rank having a card of its own (gloo on
the CPU), and the log names the backend. Each rank builds the same train
state from the seed, runs the checked steps and one step on each other
batch, then the ranks meet at a barrier and the window starts. Every step
ends with a vote over a gloo group (the least of the ranks' "my window
is over"), so all ranks stop after the same step; in a traced run rank
0's window is not over before its profiler's.

Each rank runs on its own block of the machine's cores (`own_cores`: a
1/N share, torch's threads and the matcher's as many), as PyTorch's
launcher places its workers with `torchrun --numa-binding exclusive`
(`torch/numa/binding.py`: the CPUs of a GPU's NUMA node divided evenly
among its GPUs, no two workers sharing a core). The released recipe's
`mp.spawn` places nothing; unpinned, four ranks' host threads contend,
and a step, which waits for the slowest rank, spreads with them.

A rank that fails ends the run: rank 0 watches the others and, when one
exits with an error, kills them all and exits non-zero (`_watch`, within
`POLL_S`); the others exit when rank 0's process is gone; a collective
waits at most `TIMEOUT_MIN` minutes (`tpu.distributed.timeout_min`).

End-to-end: `train_images_per_s` (the global images of the steps of rank
0's window, over it), `peak_mem_gib` (the largest of the ranks'
allocator peaks), `setup_s` (the driver's process start to the window's
start: the ranks' start and the group's set-up are in it). A traced run
profiles rank 0 alone, and its counts are of its own rows (`batch`), so
the train readers read one card. The check: rank 0's losses of the
checked steps (the mean over the ranks, the global batch's) and its
AdamW state against the training reference over the same global batches
(`judge.train_readings`), once the group is gone.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

from gpvbench import build, family, judge
from gpvbench.run import Ctx, load_file
from gpvbench.trace import (Profile, Spans, TraceData, breakdown,
                            clock_offset, profiler, read_profile,
                            warm_profiler)

_train = load_file(Path(__file__).with_name("train.py"),
                   "gpvbench_driver_train")
TIMEOUT_MIN = 1.0     # the longest a collective waits
POLL_S = 0.5          # how often a rank looks at the others
RANK_MAIN = ("import json, sys; from gpvbench.run import load_file; "
             "load_file(sys.argv[1], 'gpvbench_driver_train_ddp')"
             ".rank_main(sys.argv[2], int(sys.argv[3]))")


def rows(batch: list, world: int, rank: int) -> list:
    """The items of a global batch that `rank` of `world` holds (the
    program's `shard_rows`)."""
    from gpv_tpu_torch.parallel.mesh import shard_rows
    return [batch[i] for i in shard_rows(len(batch), world, rank)]


def own_cores(rank: int, world: int) -> list:
    """Keep this process to its rank's block of the cores it may run on
    (a 1/world share; all of them where there are fewer cores than
    ranks, or where the system refuses) and size torch's threads to it.
    Returns the cores it keeps."""
    import torch
    cores = sorted(os.sched_getaffinity(0))
    share = len(cores) // world
    if share:
        try:
            os.sched_setaffinity(0, cores[rank * share:(rank + 1) * share])
        except OSError:
            pass
    mine = sorted(os.sched_getaffinity(0))
    torch.set_num_threads(len(mine))
    return mine


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _watch(procs, done: threading.Event, log) -> None:
    """Kill every rank and end this process as soon as one rank exits
    with an error, until `done` is set."""
    while not done.wait(POLL_S):
        for r, p in enumerate(procs, 1):
            code = p.poll()
            if code not in (None, 0):
                log(f"gpvbench: rank {r} exited {code}; stopping the run")
                for q in procs:
                    if q.poll() is None:
                        q.kill()
                os._exit(3)


def _orphan_watch(parent: int) -> None:
    """End this rank once rank 0's process is gone."""
    while True:
        time.sleep(POLL_S)
        if os.getppid() != parent:
            os._exit(3)


def rank_main(spec_path: str, rank: int) -> None:
    """A rank other than 0: its process's entry (`RANK_MAIN`)."""
    threading.Thread(target=_orphan_watch, args=(os.getppid(),),
                     daemon=True).start()
    spec = json.loads(Path(spec_path).read_text())
    ctx = Ctx(spec["name"], spec["seed"], spec["seconds"], False,
              spec["device"], spec["config"], spec["traffic"],
              spec["t_start"], dtype=spec["dtype"], root=Path(spec["root"]))
    _rank(ctx, rank, spec["world"], spec["port"])


def _rank(ctx, rank: int, world: int, port: int) -> dict:
    """One rank's set-up, checked steps and window; rank 0's result."""
    import torch
    import torch.distributed as dist
    from gpv_tpu_torch.datasets.loader import Collator
    from gpv_tpu_torch.losses.criterion import LossConfig
    from gpv_tpu_torch.models.gpv import build_gpv
    from gpv_tpu_torch.parallel import mesh
    from gpv_tpu_torch.parallel.train_step import TrainState, make_train_step
    from gpv_tpu_torch.text.vocab import AnswerVocab
    from gpv_tpu_torch.text.wordpiece import WordPieceTokenizer
    from gpv_tpu_torch.train.optimizer import build_optimizer, make_schedule

    tr, conf = ctx.traffic, ctx.config
    training = conf["training"]
    cores = own_cores(rank, world)
    t = time.perf_counter()
    cluster = mesh.initialize_distributed(build.node({"distributed": {
        "coordinator_address": f"localhost:{port}", "num_processes": world,
        "process_id": rank, "timeout_min": TIMEOUT_MIN}}), ctx.device)
    votes = dist.new_group(backend="gloo")
    dev = mesh.rank_device(cluster, ctx.device)
    if rank == 0:
        ctx.split("join", time.perf_counter() - t)
        cards = ([torch.cuda.get_device_name(i) for i in range(world)]
                 if dev.type == "cuda" else [])
        ctx.log(f"gpvbench: {world} ranks joined over "
                f"{dist.get_backend()}, one {dev.type} device each "
                f"({', '.join(cards) or 'cpu'}); rank 0 on cores "
                f"{cores[0]}-{cores[-1]}")
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

    B = 4 * int(tr["per_task"])
    pool = build.Pool(ctx, int(tr["batches"]), B)
    t = time.perf_counter()
    items = _train.make_items(ctx, pool)
    collate = Collator(
        AnswerVocab(build.answer_words(V)),
        WordPieceTokenizer(build.bert_words(tr)),
        max_text_len=int(ctx.model["max_text_len"]),
        max_query_len=int(tr["max_query_len"]),
        max_target_boxes=int(ctx.model["max_target_boxes"]),
        dedup_queries=bool(training["query_dedup"]))
    batches = [collate(rows(b, world, rank)) for b in items]
    local = len(batches[0]["query_ids"])
    ctx.split("data", time.perf_counter() - t)

    # the checked steps, then one step on each other batch
    t = time.perf_counter()
    trainable = {n: p for n, p in model.named_parameters()
                 if p.requires_grad}
    prog = {"losses": []}
    checked = int(tr["checked_steps"])
    for k in range(checked):
        losses = step(state, batches[k % len(batches)])
        prog["losses"].append({n: float(v) for n, v in losses.items()})
        if k == 0 and rank == 0:
            beta1 = optimizer.param_groups[0]["betas"][0]
            prog["grad"] = {n: (optimizer.state[p].get(
                "exp_avg", torch.zeros_like(p)) / (1 - beta1)).cpu()
                            for n, p in trainable.items()}
    if rank == 0:
        prog["params"] = {n: p.detach().to("cpu", copy=True)
                          for n, p in trainable.items()}
    for k in range(checked, len(batches)):
        step(state, batches[k])
    if ctx.trace:
        warm_profiler(dev.type)
    _train._sync(dev)
    ctx.split("warmup", time.perf_counter() - t)

    spans = Spans(sync=(lambda: _train._sync(dev)))
    run_step = spans.wrap("step", step) if ctx.trace else step
    prof = profile = None
    prof_from = ctx.seconds / 3.0
    prof_len = min(float(tr["profile_s"]), ctx.seconds / 3.0)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    dist.barrier(group=votes)
    t0 = time.perf_counter()
    if rank == 0:
        ctx.log(f"gpvbench: set-up {t0 - ctx.t_start:.3f} s "
                + " ".join(f"{k} {v:.3f}" for k, v in ctx.setup.items()))
    end, n, k = t0 + ctx.seconds, 0, len(batches)
    vote = torch.zeros(1, dtype=torch.int64)
    while True:
        if ctx.trace and prof is None and profile is None \
                and time.perf_counter() - t0 >= prof_from:
            prof = profiler(dev.type)
            prof.__enter__()
            _train._sync(dev)
            p_t0, p_steps = time.perf_counter(), 0
        run_step(state, batches[k % len(batches)])
        k += 1
        n += 1
        if prof is not None:
            p_steps += 1
            if time.perf_counter() - p_t0 >= prof_len:
                _train._sync(dev)
                p_t1 = time.perf_counter()
                prof.__exit__(None, None, None)
                profile = Profile(read_profile(prof, clock_offset()), p_t0,
                                  p_t1, {"steps": p_steps})
                prof = None
        vote[0] = int(time.perf_counter() >= end
                      and (profile is not None or not ctx.trace))
        dist.all_reduce(vote, op=dist.ReduceOp.MIN, group=votes)
        if vote[0]:
            _train._sync(dev)
            break
    window = time.perf_counter() - t0
    peak = torch.tensor([float(torch.cuda.max_memory_allocated(dev))
                         if dev.type == "cuda" else 0.0])
    dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=votes)
    dist.barrier(group=votes)
    dist.destroy_process_group()
    if rank:
        return {}
    U = len(batches[0].get("query_uniq_ids", batches[0]["query_ids"]))
    del step, state, optimizer, scheduler, model, trainable, run_step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"items": items, "prog": prog, "steps": n, "window": window,
            "batch": B, "local": local, "unique": U, "peak": peak.item(),
            "profile": profile, "spans": spans, "t0": t0}


def run(ctx) -> dict:
    import torch
    tr = ctx.traffic
    world = int(tr["ranks"])
    if ctx.device == "cuda" and torch.cuda.device_count() < world:
        raise SystemExit(f"train_ddp: {world} ranks need {world} cards; "
                         f"this machine has {torch.cuda.device_count()}")
    if ctx.device == "cuda":
        from gpv_tpu_torch.ops import _cuda
        t = time.perf_counter()
        _cuda.build_all()           # once, before the ranks start
        ctx.split("build", time.perf_counter() - t)
    port = _free_port()
    tmp = Path(tempfile.mkdtemp(prefix="gpvbench_ddp_"))
    spec = tmp / "spec.json"
    spec.write_text(json.dumps({
        "name": ctx.name, "seed": ctx.seed, "seconds": ctx.seconds,
        "device": ctx.device, "config": ctx.config, "traffic": ctx.traffic,
        "t_start": ctx.t_start, "dtype": ctx.dtype, "root": str(ctx.root),
        "world": world, "port": port}))
    t = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", RANK_MAIN, __file__,
                               str(spec), str(r)], cwd=ctx.root, stdout=2,
                              stderr=2)
             for r in range(1, world)]
    ctx.split("spawn", time.perf_counter() - t)
    done = threading.Event()
    threading.Thread(target=_watch, args=(procs, done, ctx.log),
                     daemon=True).start()
    cores, threads = os.sched_getaffinity(0), torch.get_num_threads()
    try:
        out = _rank(ctx, 0, world, port)
        for p in procs:
            p.wait(timeout=60 * TIMEOUT_MIN)
    finally:
        os.sched_setaffinity(0, cores)      # the check runs on them all
        torch.set_num_threads(threads)
        done.set()
        for p in procs:
            if p.poll() is None:
                p.kill()
        spec.unlink(missing_ok=True)
        tmp.rmdir()
    bad = [p.returncode for p in procs if p.returncode]
    if bad:
        raise RuntimeError(f"train_ddp: ranks exited {bad}")

    B, n, window = out["batch"], out["steps"], out["window"]
    metrics = {"setup_s": out["t0"] - ctx.t_start,
               "train_images_per_s": n * B / window,
               "peak_mem_gib": out["peak"] / 2 ** 30}
    ctx.log(f"gpvbench: {n} steps of {B} ({out['local']} a rank) over "
            f"{world} ranks in {window:.3f} s; "
            f"{metrics['train_images_per_s']:.3f} images/s")
    result = {"metrics": metrics, "attempted": n, "failed": 0, "trace": None}
    profile = out["profile"]
    if ctx.trace:
        counts = family.counts(ctx.config)
        profile.counts["flops_per_step"] = counts.train_flops(
            ctx.model, int(ctx.config["vocab_size"]), out["local"],
            out["unique"], *tr["image_hw"], int(tr["max_query_len"]),
            int(ctx.model["max_text_len"]))
        result["breakdown"] = breakdown(profile.events, out["spans"],
                                        profile.t0, profile.t1)
        result["trace"] = TraceData(ctx.model, out["spans"], profile,
                                    {"batch": out["local"]})
    if ctx.device == "cuda":
        result["device"] = dict(build.device_info(int(out["peak"]),
                                                  profile), count=world)
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu",
                            "count": world, "memory_peak_bytes": 0}
    checked = int(tr["checked_steps"])
    t = time.perf_counter()
    result["readings"] = judge.train_readings(ctx, out["items"][:checked],
                                              out["prog"])
    ctx.log(f"gpvbench: reference over {checked} steps "
            f"{time.perf_counter() - t:.3f} s")
    return result
