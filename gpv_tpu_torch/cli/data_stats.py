"""Dataset statistics CLI (the port's `gpv_tpu.cli.data_stats`):
`python -m gpv_tpu_torch.cli.data_stats data_dir=<dir>` (reference
`data/data_stats.py` + `data/create_index.py`)."""
import json
import sys
from pathlib import Path


def main(argv=None):
    from gpv_tpu_torch.data.index import create_image_index, data_stats
    from gpv_tpu_torch.utils.config import load_config

    # configs/data/data_stats.yaml drives the dataset list + split
    # (reference configs/data/data_stats.yaml schema)
    cfg = load_config("configs", "data/data_stats",
                      list(argv if argv is not None else sys.argv[1:]))
    root = Path(cfg.data_dir) / "learning_phase_data"
    split = cfg.split

    task_samples = {}
    per_subset = {}
    for task in cfg.datasets:
        d = root / task / split if task != "refcocop" else root / task
        if not d.exists():
            continue
        per_subset[task] = {}
        for f in sorted(d.glob("*.json")):
            if "count" in f.name:
                continue
            samples = json.loads(f.read_text())
            if isinstance(samples, list):
                per_subset[task][f.stem] = samples
        if "train" in per_subset[task]:
            task_samples[task] = per_subset[task]["train"]

    stats = data_stats(per_subset)
    print(json.dumps(stats, indent=1))
    if task_samples:
        index = create_image_index(task_samples)
        out = root / f"image_index_{split}.json"
        out.write_text(json.dumps(index))
        print(f"image index ({len(index)} images) -> {out}")


if __name__ == "__main__":
    main()
