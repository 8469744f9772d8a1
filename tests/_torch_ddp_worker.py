"""One rank of the port's data-parallel step, for
tests/test_torch_port_ddp.py:

    RANK=r WORLD_SIZE=W MASTER_ADDR=... MASTER_PORT=... \\
        python tests/_torch_ddp_worker.py <dir>

`<dir>` holds `model.pt` (a pickled port GPV), `batch.npz` (the global
batch) and `spec.json` ({"grad_accum", "training"}: the optimizer's
`training` node). The rank joins through `parallel.mesh` on the CPU
(gloo), takes its rows of the global batch (`mesh.shard_rows`), runs one
`make_train_step` step under DDP and writes `rank<r>.pt`: the losses, the
parameters after the step, the clipped gradients and the first dropout
mask it drew. It imports no JAX.
"""
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist


def main(directory: str) -> None:
    from gpv_tpu_torch.losses.criterion import LossConfig
    from gpv_tpu_torch.parallel import mesh
    from gpv_tpu_torch.parallel.train_step import TrainState, make_train_step
    from gpv_tpu_torch.train.optimizer import build_optimizer
    from gpv_tpu_torch.utils.config import ConfigNode

    torch.set_num_threads(1)
    d = Path(directory)
    spec = json.loads((d / "spec.json").read_text())
    cluster = mesh.initialize_distributed({}, "cpu")
    model = torch.load(d / "model.pt", weights_only=False)
    batch = dict(np.load(d / "batch.npz"))
    rows = mesh.shard_rows(len(batch["image"]), cluster.world, cluster.rank,
                           spec["grad_accum"])
    local = {k: v[rows] for k, v in batch.items()}

    masks = []
    real_rand = torch.rand

    def recording_rand(*args, **kwargs):  # dropout's draws
        out = real_rand(*args, **kwargs)
        if kwargs.get("generator") is not None and not masks:
            masks.append(out.clone())
        return out
    torch.rand = recording_rand

    opt, sched = build_optimizer(ConfigNode(spec["training"]), 10, model)
    step = make_train_step(model, LossConfig(), 0.1,
                           grad_accum=spec["grad_accum"])
    losses = step(TrainState(model, opt, sched), local)
    torch.save({"losses": {k: float(v) for k, v in losses.items()},
                "params": {k: v.clone() for k, v in
                           model.state_dict().items()},
                "grads": {n: p.grad.clone()
                          for n, p in model.named_parameters()
                          if p.grad is not None},
                "masks": masks, "rows": rows},
               d / f"rank{cluster.rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
