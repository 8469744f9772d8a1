"""The four-card training cell's path on the CPU: the benchmark's
`train_ddp` driver (`gpvbench/drivers/train_ddp.py`) over the port's
`parallel.mesh` and DDP train step, under gloo.

- The driver deals every global batch's rows out by the program's
  `shard_rows`: each row to one rank, each rank a mix of the four tasks.
- Two gloo ranks at a tiny size run the cell's driver end to end: its
  checked steps match the training reference over the global batch, and
  the train step's communication hook (`parallel.train_step.
  allreduce_hook`) counts every step's buckets, whose bytes are the
  trainable gradients' once a step.
"""
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from gpv_tpu_torch.models.gpv import build_gpv
from gpv_tpu_torch.parallel import train_step
from gpv_tpu_torch.train.optimizer import frozen_names
from gpvbench import build, run
from gpvbench.tests.tiny import tiny

ROOT = Path(__file__).resolve().parents[1]
CELL = "train-ddp4-r50"


def driver():
    return run.load_file(ROOT / "gpvbench" / "drivers" / "train_ddp.py",
                         "gpvbench_driver_train_ddp")


def test_rows_deal_each_row_once_and_mix_the_tasks():
    ddp = driver()
    ctx = run.make_ctx(run.manifest(ROOT), CELL, 2 ** 31 + 5, 1.0, False,
                       "cpu", time.perf_counter(), ROOT)
    tr = ctx.traffic
    B = 4 * tr["per_task"]
    pool = SimpleNamespace(images=np.zeros((tr["batches"], B, 2, 2, 3),
                                           np.uint8))
    world = int(tr["ranks"])
    for batch in ddp._train.make_items(ctx, pool):
        dealt = [ddp.rows(batch, world, r) for r in range(world)]
        assert [len(d) for d in dealt] == [B // world] * world
        ids = sorted(id(it) for d in dealt for it in d)
        assert ids == sorted(id(it) for it in batch)
        for d in dealt:
            assert len({it["task"] for it in d}) == 4


def test_two_gloo_ranks_run_the_cell_and_count_the_hook():
    man = run.manifest(ROOT)
    ctx = tiny(run.make_ctx(man, CELL, 2 ** 31 + 11, 1.0, False, "cpu",
                            time.perf_counter(), ROOT))
    ctx.traffic["ranks"] = 2
    ctx.log = lambda line: None
    before = dict(train_step.COUNTERS)
    out = ctx.driver().run(ctx)
    limits = ctx.config["limits"]
    assert all(out["readings"][k] <= limits[k] for k in limits), \
        out["readings"]
    assert out["device"]["count"] == 2 and out["attempted"] > 0
    assert out["metrics"]["train_images_per_s"] > 0
    calls = train_step.COUNTERS["ddp.allreduce_calls"] - \
        before["ddp.allreduce_calls"]
    sent = train_step.COUNTERS["ddp.allreduce_bytes"] - \
        before["ddp.allreduce_bytes"]
    model = build_gpv(build.node(ctx.model), int(ctx.config["vocab_size"]))
    frozen = frozen_names(model, False, None)
    grad_bytes = 4 * sum(p.numel() for n, p in model.named_parameters()
                         if n not in frozen)
    steps = int(ctx.traffic["batches"]) + out["attempted"]
    assert sent == steps * grad_bytes
    # DDP rebuilds its buckets after the first step, so the count of calls
    # a step may change once; each step enqueues one bucket or more
    assert calls >= steps
    assert not torch.distributed.is_initialized()
