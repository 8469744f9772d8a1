"""Training CLI (the port's `gpv_tpu.cli.train`):

    python -m gpv_tpu_torch.cli.train learning_datasets=all \
        [training.batch_size=120] [training.grad_accum_steps=1] \
        [tpu.dtype=bfloat16] [device=cpu] <overrides...>

Run from a checkout (it reads `configs/exp/gpv.yaml`). Behavior spec:
reference `python -m exp.gpv.train_distr` (`train_distr.py:478-495`):
compose the config with dotted overrides, write it to
`exp_dir/config.yaml`, and run the multitask trainer, on the card unless
`device=cpu`.
"""
import sys
from pathlib import Path


def main(argv=None):
    from gpv_tpu_torch.train.trainer import Trainer
    from gpv_tpu_torch.utils.config import load_config, save_config

    overrides = list(argv if argv is not None else sys.argv[1:])
    cfg = load_config("configs", "exp/gpv", overrides)
    Path(cfg.exp_dir).mkdir(parents=True, exist_ok=True)
    save_config(cfg, Path(cfg.exp_dir) / "config.yaml")
    return Trainer(cfg).train()


if __name__ == "__main__":
    main()
