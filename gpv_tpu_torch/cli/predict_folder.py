"""Batch inference over a directory of images -> JSONL (the port's
`gpv_tpu.cli.predict_folder`).

Point it at any folder of JPEG/PNG images with one query (or a .txt of
per-image queries) and get one JSON line per image:

  python -m gpv_tpu_torch.cli.predict_folder images=<dir> ckpt=<path> \
      query="what is this?" \
      [out=predictions.jsonl] [batch=20] [task=classification] \
      [queries=<file.txt>]            # one query per line, paired by sort
      [resize=true]                   # false -> native-resolution buckets
      [num_output_boxes=5] [device=cpu]

`ckpt=` is required (`ckpt=null` opts into random weights explicitly —
the tool never writes garbage predictions because a path was forgotten).

Images are resized to the training resolution by default, and the last
partial batch is padded by repetition, so every engine call has one batch
shape; `resize=false` switches to `predict_native`'s shape-bucketed path.
Needs PIL to decode the images.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}
TASKS = ("vqa", "captioning", "detection", "classification",
         "classification_syns")


def iter_image_files(root: Path):
    return sorted(p for p in Path(root).rglob("*")
                  if p.suffix.lower() in IMAGE_EXTS)


def load_rgb(path) -> np.ndarray:
    """Arbitrary user images: palette, grayscale and RGBA PNGs decode to
    real RGB pixels (`datasets.image.load_image` reads COCO JPEGs)."""
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def main(argv=None):
    from gpv_tpu_torch.datasets.image import resize_uint8
    from gpv_tpu_torch.evaluation.vocab_mask import coco_vocab_mask
    from gpv_tpu_torch.infer.build import build_engine
    from gpv_tpu_torch.utils.config import load_config

    raw = list(argv if argv is not None else sys.argv[1:])
    local = {}
    overrides = []
    for o in raw:
        k, _, v = o.partition("=")
        if k in ("images", "query", "queries", "out", "batch", "task",
                 "resize", "num_output_boxes"):
            local[k] = v
        else:
            overrides.append(o)
    if "images" not in local:
        raise SystemExit("required: images=<directory>")
    task = local.get("task")
    if task is not None and task not in TASKS:
        # fail fast (before the engine build); never silently drop a
        # misspelled flag (serve_http returns 400 for the same case)
        raise SystemExit(f"unknown task {task!r}; known: {TASKS}")

    # cheap input validation first — before the ckpt requirement and the
    # (expensive) engine build
    files = iter_image_files(Path(local["images"]))
    if not files:
        raise SystemExit(f"no images under {local['images']} "
                         f"(extensions: {sorted(IMAGE_EXTS)})")

    if "queries" in local:
        queries = Path(local["queries"]).read_text().splitlines()
        if len(queries) != len(files):
            raise SystemExit(
                f"queries file has {len(queries)} lines for "
                f"{len(files)} images (paired by sorted filename)")
    else:
        queries = [local.get("query", "what is this?")] * len(files)

    if not any(o.startswith("ckpt=") for o in overrides):
        raise SystemExit(
            "required: ckpt=<checkpoint path> "
            "(or ckpt=null explicitly to run with random weights)")
    cfg = load_config("configs", "exp/gpv_inference", overrides)
    engine = build_engine(cfg)

    mask = None
    if task in ("classification", "classification_syns"):
        mask = coco_vocab_mask(engine.vocab,
                               use_syns=task == "classification_syns")
    # vqa/captioning/detection carry the task in the query text itself,
    # as upstream — no mask

    do_resize = str(local.get("resize", "true")).lower() != "false"
    H = int(cfg.task_configs.image_size.H)
    W = int(cfg.task_configs.image_size.W)
    resize_method = str(cfg.task_configs.get("host_resize", "pil"))
    batch = int(local.get("batch", 20))
    nb = int(local.get("num_output_boxes", 5))
    out_path = Path(local.get("out", "predictions.jsonl"))

    with out_path.open("w") as f:
        for start in range(0, len(files), batch):
            chunk = files[start:start + batch]
            qs = list(queries[start:start + batch])
            imgs = [load_rgb(p) for p in chunk]
            if do_resize:
                n_real = len(imgs)
                resized = [resize_uint8(im, H, W, method=resize_method)
                           for im in imgs]
                while len(resized) < batch:
                    resized.append(resized[-1])
                    qs.append(qs[-1])
                outs = engine.predict(np.stack(resized), qs,
                                      vocab_mask=mask)[:n_real]
                qs = qs[:n_real]
            else:
                outs = engine.predict_native(imgs, qs, vocab_mask=mask)
            for p, q, o in zip(chunk, qs, outs):
                f.write(json.dumps({
                    "file": str(p), "query": q, "answer": o["answer"],
                    "boxes": np.asarray(o["boxes"])[:nb].tolist(),
                    "relevance":
                        np.asarray(o["relevance"])[:nb].tolist()}) + "\n")
            print(f"{min(start + batch, len(files))}/{len(files)}",
                  flush=True)
    print(f"wrote {out_path}")
    return out_path


if __name__ == "__main__":
    main()
