"""Training CLI (the port's `gpv_tpu.cli.train`):

    python -m gpv_tpu_torch.cli.train learning_datasets=all \
        [training.batch_size=120] [training.grad_accum_steps=1] \
        [tpu.dtype=bfloat16] [device=cpu] <overrides...>

Run from a checkout (it reads `configs/exp/gpv.yaml`). Behavior spec:
reference `python -m exp.gpv.train_distr` (`train_distr.py:478-495`):
compose the config with dotted overrides, write it to
`exp_dir/config.yaml` (rank 0), and run the multitask trainer, on the card
unless `device=cpu`. On N cards, one process per card:

    python -m torch.distributed.run --nproc-per-node N \
        -m gpv_tpu_torch.cli.train <overrides...>

or each process with `tpu.distributed.coordinator_address=host:port
tpu.distributed.num_processes=N tpu.distributed.process_id=<rank>`
(`parallel.mesh`). `tpu.mesh.model=M` shards the model over M of one
host's processes (tensor parallelism, `train.trainer`).
"""
import sys
from pathlib import Path


def main(argv=None):
    from gpv_tpu_torch.parallel.mesh import cluster_from_config
    from gpv_tpu_torch.train.trainer import Trainer
    from gpv_tpu_torch.utils.config import load_config, save_config

    overrides = list(argv if argv is not None else sys.argv[1:])
    cfg = load_config("configs", "exp/gpv", overrides)
    Path(cfg.exp_dir).mkdir(parents=True, exist_ok=True)
    cluster = cluster_from_config(cfg.get("tpu"))
    if cluster is None or cluster.rank == 0:
        save_config(cfg, Path(cfg.exp_dir) / "config.yaml")
    return Trainer(cfg).train()


if __name__ == "__main__":
    main()
