"""One rank of the port's tensor-parallel runs, for
tests/test_torch_port_tp.py:

    RANK=r WORLD_SIZE=W MASTER_ADDR=... MASTER_PORT=... \\
        python tests/_torch_tp_worker.py <dir>

`<dir>` holds `spec.json` ({"task": "step" | "forward" | "cli", "data",
"model", ...}). The rank joins through `parallel.mesh` on the CPU (gloo)
as a (data, model) mesh and
  - "step": makes `model.pt` (a pickled whole port GPV) its shard
    (`models.gpv.shard_params`), takes its data index's rows of the global
    batch `batch.npz` (`mesh.shard_rows`), runs `steps` steps of
    `make_train_step` (`grad_accum`, optimizer node `training`), and
    writes each step's losses, its own parameters and clipped gradients,
    and the whole ones gathered over its model group;
  - "forward": shards `model.pt` the same way and runs the deterministic
    forward (encode, teacher-forced answer logits, greedy decode) on the
    batch, writing its outputs;
  - "cli": runs `gpv_tpu_torch.cli.train.main(argv)`; with `resume`, its
    `train()` only gathers the state the trainer restored and rank 0
    writes it as `restored.pt`, in the checkpoint's format;
to `rank<r>.pt`. It imports no JAX.

`run_ranks` starts ranks of one group as fresh processes on a free local
port, each with a timeout of its own (the tests' harness).
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 180


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> dict:
    env = dict(os.environ)
    env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p]))
    return env


def run_ranks(directory, world: int, timeout: float = RANK_TIMEOUT_S):
    """Run this worker as `world` ranks of one group on `directory`; each
    must exit 0 within `timeout` s. Returns their outputs."""
    port = free_port()
    procs = [subprocess.Popen([sys.executable, __file__, str(directory)],
                              cwd=ROOT, env=rank_env(r, world, port),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out}"
    return outs


def _step(spec, model, batch, cluster, mesh):
    from gpv_tpu_torch.losses.criterion import LossConfig
    from gpv_tpu_torch.parallel.tensor_parallel import gather_shards
    from gpv_tpu_torch.parallel.train_step import TrainState, make_train_step
    from gpv_tpu_torch.train.optimizer import build_optimizer
    from gpv_tpu_torch.utils.config import ConfigNode

    g = mesh.groups()
    rows = mesh.shard_rows(len(batch["image"]), g.mesh.data, g.data_index,
                           spec["grad_accum"])
    local = {k: v[rows] for k, v in batch.items()}
    opt, sched = build_optimizer(ConfigNode(spec["training"]), 10, model)
    step = make_train_step(model, LossConfig(), 0.1,
                           grad_accum=spec["grad_accum"])
    state = TrainState(model, opt, sched)
    losses = [{k: float(v) for k, v in step(state, local).items()}
              for _ in range(spec.get("steps", 1))]
    specs, mg = model.tp_rules.specs, model.tp
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    params = {k: v.clone() for k, v in model.state_dict().items()}
    return {"losses": losses[-1], "step_losses": losses,
            "params": params, "grads": grads, "rows": rows,
            "full_params": gather_shards(params, specs, mg),
            "full_grads": gather_shards(grads, specs, mg),
            "sharded": sorted(specs), "data_index": g.data_index,
            "model_index": g.model_index}


@torch.no_grad()
def _forward(spec, model, batch):
    from gpv_tpu_torch.decode.greedy import greedy_decode
    images = torch.from_numpy(batch["images"])
    ids = torch.from_numpy(batch["ids"]).long()
    valid = torch.from_numpy(batch["valid"])
    memory, mem_valid, out = model.encode(images, ids, query_valid=valid)
    logits = model(images, ids, torch.from_numpy(batch["answer_ids"]).long(),
                   query_valid=valid)["answer_logits"]
    tokens, step_logits, _ = greedy_decode(model, memory, mem_valid,
                                           spec["cls_id"])
    return {"pred_boxes": out["pred_boxes"],
            "pred_relevance_logits": out["pred_relevance_logits"],
            "memory": memory, "answer_logits": logits, "tokens": tokens,
            "step_logits": step_logits}


def _cli(spec, d):
    from gpv_tpu_torch.cli import train as cli
    from gpv_tpu_torch.train import checkpoint, trainer

    def restored(self):
        payload = checkpoint._payload(self.state)  # gathers: every rank
        if self.is_main:
            torch.save(payload, d / "restored.pt")
        return {}
    if spec["resume"]:
        trainer.Trainer.train = restored
    cli.main(spec["argv"])


def main(directory: str) -> None:
    from gpv_tpu_torch.models.gpv import shard_params
    from gpv_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    d = Path(directory)
    spec = json.loads((d / "spec.json").read_text())
    if spec["task"] == "cli":
        _cli(spec, d)
        return
    cluster = mesh.initialize_distributed(
        {"mesh": {"data": spec["data"], "model": spec["model"]}}, "cpu")
    model = torch.load(d / "model.pt", weights_only=False)
    shard_params(model, mesh.model_group())
    batch = dict(np.load(d / "batch.npz"))
    if spec["task"] == "step":
        out = _step(spec, model, batch, cluster, mesh)
    else:
        out = _forward(spec, model.eval(), batch)
    torch.save(out, d / f"rank{cluster.rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
