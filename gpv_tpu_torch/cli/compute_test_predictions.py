"""Eval-server prediction CLI (the port's
`gpv_tpu.cli.compute_test_predictions`): VQA test/testdev, COCO captioning
test.

    python -m gpv_tpu_torch.cli.compute_test_predictions kind=vqa|cap \
        eval.subset=test eval.ckpt=<model.pth | null> [device=cpu] ...

Behavior spec: reference `exp/gpv/compute_vqa_test_predictions.py` /
`compute_cap_test_predictions.py` + their eval_{vqa,cap}_test.sh scripts.
Writes `exp_dir/eval/{vqa,cap}_{subset}_predictions.json`.
"""
import sys
from pathlib import Path


def main(argv=None):
    from gpv_tpu_torch.cli.compute_predictions import resolve_ckpt
    from gpv_tpu_torch.datasets.coco import (CocoCapTestOriginalSplit,
                                             CocoVqaTestOriginalSplit)
    from gpv_tpu_torch.infer.build import build_engine
    from gpv_tpu_torch.infer.predictions import (
        compute_cap_test_predictions, compute_vqa_test_predictions)
    from gpv_tpu_torch.utils.config import load_config

    args = list(argv or sys.argv[1:])
    overrides = [o for o in args if not o.startswith("kind=")]
    kind = next((o.split("=", 1)[1] for o in args
                 if o.startswith("kind=")), "vqa")
    cfg = load_config("configs", "exp/gpv",
                      ["task_configs.data_split=original_split"] + overrides)
    subset = cfg.eval.subset
    resolve_ckpt(cfg)
    engine = build_engine(cfg)
    out_dir = Path(cfg.exp_dir) / "eval"
    out_dir.mkdir(parents=True, exist_ok=True)

    if kind == "vqa":
        ds = CocoVqaTestOriginalSplit(cfg.task_configs.coco_vqa, subset)
        out = out_dir / f"vqa_{subset}_predictions.json"
        compute = compute_vqa_test_predictions
    else:
        ds = CocoCapTestOriginalSplit(cfg.task_configs.coco_captioning,
                                      subset)
        out = out_dir / f"cap_{subset}_predictions.json"
        compute = compute_cap_test_predictions
    compute(engine, ds, int(cfg.eval.batch_size), out,
            num_workers=int(cfg.eval.get("num_workers", 8)),
            loader=str(cfg.eval.get("loader", "threads")))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
