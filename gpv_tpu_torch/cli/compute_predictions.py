"""Offline eval CLI (the port's `gpv_tpu.cli.compute_predictions`):

    python -m gpv_tpu_torch.cli.compute_predictions eval.task=CocoVqa \
        eval.subset=val eval.ckpt=<model.pth | null> [eval.beam_size=5] \
        [eval.num_workers=8] [eval.loader=threads|processes] \
        [eval.predict=False] [device=cpu] <overrides...>

Run from a checkout (it reads `configs/exp/gpv.yaml`). Behavior spec:
reference `python -m exp.gpv.compute_predictions`
(`compute_predictions.py:127-191`): batched inference over the chosen
task/subset -> HDF5 boxes + predictions JSON -> per-novelty evaluator
metrics, under `exp_dir/eval`. The engine runs on the card unless
`device=cpu`; `eval.predict=False` re-scores the files already written,
without an engine.
"""
import json
import sys
from pathlib import Path

TASK_CONFIGS = {
    "CocoVqa": "coco_vqa", "CocoCaptioning": "coco_captioning",
    "CocoClassification": "coco_classification",
    "CocoDetection": "coco_detection", "RefCocop": "refcocop",
}


def resolve_ckpt(cfg) -> None:
    """`eval.ckpt` -> `ckpt`: null means random weights, asked for; a path
    that does not exist is refused (never score random weights by a typo)."""
    ckpt = cfg.eval.get("ckpt")
    if ckpt and not Path(str(ckpt)).exists():
        raise SystemExit(
            f"eval.ckpt not found: {ckpt} "
            "(pass eval.ckpt=null explicitly to run with random weights)")
    cfg["ckpt"] = ckpt or None


def main(argv=None):
    from gpv_tpu_torch.datasets.coco import DATASET_CLASSES
    from gpv_tpu_torch.infer.build import build_engine
    from gpv_tpu_torch.infer.predictions import (evaluate_predictions,
                                                 make_predictions)
    from gpv_tpu_torch.utils.config import load_config

    overrides = list(argv if argv is not None else sys.argv[1:])
    cfg = load_config("configs", "exp/gpv", overrides)
    task = cfg.eval.task
    subset = cfg.eval.subset
    resolve_ckpt(cfg)

    ld = cfg.learning_datasets
    task_cfg_name = ((ld[task].task_config if task in ld else None)
                     or TASK_CONFIGS[task])
    task_cfg = cfg.task_configs[task_cfg_name]
    dataset = DATASET_CLASSES[task](task_cfg, subset, training=False)

    eval_dir = Path(cfg.exp_dir) / "eval"
    data_split = cfg.task_configs.data_split
    if cfg.eval.get("predict", True):
        engine = build_engine(cfg)
        beam_size = cfg.eval.get("beam_size")
        predictions, boxes_path, _ = make_predictions(
            engine, dataset, task, int(cfg.eval.batch_size), eval_dir,
            subset, data_split, cfg.eval.get("num_eval_batches"),
            beam_size=int(beam_size) if beam_size else None,
            num_workers=int(cfg.eval.get("num_workers", 8)),
            loader=str(cfg.eval.get("loader", "threads")))
    else:
        pred_path = (eval_dir
                     / f"{task}_{data_split}_{subset}_predictions.json")
        predictions = json.loads(pred_path.read_text())
        boxes_path = eval_dir / f"{task}_{subset}_boxes.h5py"

    metrics = evaluate_predictions(
        task, dataset.samples, predictions, boxes_path, eval_dir, subset,
        data_split,
        image_dir=task_cfg.image_dir if task in ("CocoDetection",
                                                 "RefCocop") else None)
    print(metrics.get("everything"))
    return metrics


if __name__ == "__main__":
    main()
