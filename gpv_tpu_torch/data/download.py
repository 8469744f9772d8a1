"""Dataset downloader (COCO 2014, VQA v2, RefCOCO+; counterpart of
`gpv_tpu/data/download.py`: the same URL tree and job order).

Behavior spec: reference `data/coco/download.py` + `configs/data/download.yaml`
URL tree + `setup_data.sh`: wget each archive into
`{data_dir}/learning_phase_data/...` and unzip. Flags reproduce
`download_coco_images_only` / `download_coco_test_images`.
"""
from __future__ import annotations

import subprocess
import zipfile
from pathlib import Path

URLS = {
    "coco": {
        "images": {
            "train2014": "http://images.cocodataset.org/zips/train2014.zip",
            "val2014": "http://images.cocodataset.org/zips/val2014.zip",
            "test2014": "http://images.cocodataset.org/zips/test2014.zip",
        },
        "anno": {
            "trainval2014": ("http://images.cocodataset.org/annotations/"
                             "annotations_trainval2014.zip"),
            "test2014": ("http://images.cocodataset.org/annotations/"
                         "image_info_test2014.zip"),
        },
    },
    "vqa": {
        "questions": {
            s: ("https://s3.amazonaws.com/cvmlp/vqa/mscoco/vqa/"
                f"v2_Questions_{n}_mscoco.zip")
            for s, n in (("train", "Train"), ("val", "Val"),
                         ("test", "Test"))},
        "anno": {
            s: ("https://s3.amazonaws.com/cvmlp/vqa/mscoco/vqa/"
                f"v2_Annotations_{n}_mscoco.zip")
            for s, n in (("train", "Train"), ("val", "Val"))},
    },
    "refcocop": {
        "anno": {"zip": ("http://bvisionweb1.cs.unc.edu/licheng/referit/"
                         "data/refcoco+.zip")},
    },
}


def download_url(url: str, dest_dir: Path) -> Path:
    dest_dir.mkdir(parents=True, exist_ok=True)
    dest = dest_dir / url.split("/")[-1]
    if not dest.exists():
        subprocess.run(["wget", "-q", "-O", str(dest), url], check=True)
    return dest


def unzip(archive: Path, dest_dir: Path):
    with zipfile.ZipFile(archive) as zf:
        zf.extractall(dest_dir)


def download_all(data_dir: str | Path, images_only: bool = False,
                 include_test_images: bool = False, urls=None):
    """`urls` defaults to the module URL tree; the download CLI passes the
    tree from `configs/data/download.yaml` (same schema as the reference's
    `configs/data/download.yaml`) so it is overridable per run."""
    urls = urls if urls is not None else URLS
    root = Path(data_dir) / "learning_phase_data"
    jobs = []
    img_subsets = ["train2014", "val2014"]
    if include_test_images:
        img_subsets.append("test2014")
    for s in img_subsets:
        jobs.append((urls["coco"]["images"][s], root / "coco/images"))
    if not images_only:
        jobs.append((urls["coco"]["anno"]["trainval2014"], root / "coco"))
        if include_test_images:
            jobs.append((urls["coco"]["anno"]["test2014"], root / "coco"))
        for kind in ("questions", "anno"):
            for s, url in urls["vqa"][kind].items():
                jobs.append((url, root / f"vqa/{kind}"))
        jobs.append((urls["refcocop"]["anno"]["zip"], root / "refcocop"))
    for url, dest in jobs:
        archive = download_url(url, dest)
        unzip(archive, dest)
