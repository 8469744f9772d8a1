"""COCO-SCE split CLI: original_split sample JSONs -> gpv_split (the
port's `gpv_tpu.cli.make_sce_split`: the same files and printed lines).

`python -m gpv_tpu_torch.cli.make_sce_split data_dir=<dir> [seed=0]
    [train_frac=0.9]`

Reproduces the reference pipeline: split_categories + split_images +
split_data_by_categories for each of the 4 tasks/subsets
(`data/coco/split_categories.py`, `data/coco/split_images.py`,
`data/split_data_by_categories.py`).
"""
import json
import sys
from pathlib import Path


def main(argv=None):
    from gpv_tpu_torch.data.preprocess import dump_samples
    from gpv_tpu_torch.data.splits import (split_categories,
                                     split_data_by_categories, split_images)
    from gpv_tpu_torch.evaluation.vocab_mask import coco_synonyms
    from gpv_tpu_torch.utils.config import load_config

    overrides = list(argv if argv is not None else sys.argv[1:])
    # config group drives the three reference stages
    # (configs/data/split_coco_{categories,images}.yaml +
    #  split_data_by_categories.yaml — reference configs/data/ schema)
    cat_cfg = load_config("configs", "data/split_coco_categories", overrides)
    img_cfg = load_config("configs", "data/split_coco_images", overrides)
    split_cfg = load_config("configs", "data/split_data_by_categories",
                            overrides)
    root = Path(cat_cfg.data_dir) / "learning_phase_data"
    seed = int(cat_cfg.seed)
    train_frac = float(img_cfg.train_frac)

    inst = json.loads(
        (Path(cat_cfg.download_dir) / cat_cfg.instances["train"]).read_text())
    category_split = split_categories(inst["categories"], seed=seed)
    cat_path = Path(split_cfg.coco_category_split)
    cat_path.parent.mkdir(parents=True, exist_ok=True)
    cat_path.write_text(json.dumps(category_split))

    train_ids = [im["id"] for im in inst["images"]]
    img_splits = split_images(train_ids, "train", "train2014", train_frac,
                              int(img_cfg.seed))
    val_inst_path = Path(cat_cfg.download_dir) / cat_cfg.instances["val"]
    if val_inst_path.exists():
        val_ids = [im["id"]
                   for im in json.loads(val_inst_path.read_text())["images"]]
        img_splits.update(split_images(val_ids, "val", "val2014"))
    img_path = Path(split_cfg.split_coco_images)
    img_path.parent.mkdir(parents=True, exist_ok=True)
    img_path.write_text(json.dumps(img_splits))

    syn = coco_synonyms()
    task_to_name = {
        "coco_vqa": "vqa", "coco_captions": "coco_captions",
        "coco_detection": "coco_detection",
        "coco_classification": "coco_classification",
    }
    for task, ds_name in task_to_name.items():
        for subset in ("train", "val", "test"):
            src = root / f"{task}/original_split"
            # source per gpv subset from the config's dataset mapping
            # (reference split_data_by_categories.yaml: gpv train AND val
            # both come from COCO train.json — the train2014 holdout ids
            # form gpv val; COCO val.json becomes gpv test). Reading
            # val.json for gpv val produced an EMPTY val split (subset
            # mismatch against the train2014-derived image ids).
            src_file = src / str(split_cfg.dataset[subset])
            if not src_file.exists():
                continue
            samples = json.loads(src_file.read_text())
            kept, discarded, counts = split_data_by_categories(
                samples, category_split, ds_name, subset,
                img_splits[subset], syn)
            dump_samples(kept, root / f"{task}/gpv_split", subset)
            (root / f"{task}/gpv_split/{subset}_category_counts.json"
             ).write_text(json.dumps(
                 {k: dict(v) for k, v in counts.items()}))
            print(f"{task}/{subset}: kept {len(kept)}, "
                  f"discarded {len(discarded)}")


if __name__ == "__main__":
    main()
