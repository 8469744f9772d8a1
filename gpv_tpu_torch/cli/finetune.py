"""RefCOCO+ finetuning CLI (the port's `gpv_tpu.cli.finetune`):

    python -m gpv_tpu_torch.cli.finetune training.ckpt=<ckpt> \
        [device=cpu] <overrides...>

Run from a checkout. Behavior spec: reference `python -m
exp.gpv.finetune_distr` (`finetune_distr.py:443-460`): the trainer over
refcocop data, selection metric refexp mAP, eval every
`training.eval_every` epochs, and a checkpoint load that does not restore
step or epoch. One process per card as `cli.train` (`python -m
torch.distributed.run --nproc-per-node N -m gpv_tpu_torch.cli.finetune
...`, or the `tpu.distributed.*` keys).
"""
import sys
from pathlib import Path


def main(argv=None):
    from gpv_tpu_torch.train.trainer import Trainer
    from gpv_tpu_torch.utils.config import load_config

    overrides = ["learning_datasets=refcocop"] + list(
        argv if argv is not None else sys.argv[1:])
    cfg = load_config("configs", "exp/gpv", overrides)
    Path(cfg.exp_dir).mkdir(parents=True, exist_ok=True)
    return Trainer(cfg, finetune=True).train()


if __name__ == "__main__":
    main()
