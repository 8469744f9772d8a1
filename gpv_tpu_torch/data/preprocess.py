"""Offline task preprocessors: raw COCO/VQA annotations -> unified sample
JSONs (counterpart of `gpv_tpu/data/preprocess.py`; templates copied word
for word).

Behavior spec: reference `data/coco/preprocess_coco_{detection,captions,
classification}.py` and `data/vqa/preprocess_vqa.py` — each emits per-subset
lists of `{query (random template), answer?, boxes?, ids..., image:{subset,
image_id}}`. Query templates are reproduced verbatim (they are part of the
data distribution the model is trained on).
"""
from __future__ import annotations

import json
import random
from collections import Counter
from pathlib import Path
from typing import Dict, List

DETECTION_TEMPLATES = [
    "Locate {}.", "Locate {} in the image.", "Locate {} in this image.",
    "Locate instances of {}.", "Locate instances of {} in the image.",
    "Locate instances of {} in this image.",
    "Locate all instances of {}.",
    "Locate all instances of {} in the image.",
    "Locate all instances of {} in this image.",
    "Find {}.", "Find {} in the image.", "Find {} in this image.",
    "Find instances of {}.", "Find instances of {} in the image.",
    "Find instances of {} in this image.",
    "Find all instances of {}.",
    "Find all instances of {} in the image.",
    "Find all instances of {} in this image.",
]

CAPTION_TEMPLATES = [
    "Generate a caption.", "Generate a description.",
    "Describe this image.", "Describe the image.",
    "Caption this image.", "Caption the image.",
    "What is happening in this image.", "What is happening in the image.",
    "What is going on in this image.", "What is going on in the image.",
    "Generate a caption for this image.",
    "Generate a caption for the image.",
    "Generate a description for this image.",
    "Generate a description for the image.",
]

CLASSIFICATION_TEMPLATES = [
    "What is this?", "What is this object?", "What object is this?",
    "What is this thing?",
]


def _subset_of(image_path: str) -> str:
    return image_path.split("_")[1]


def preprocess_detection(instances_json: Dict, rng=None) -> List[Dict]:
    """COCO instances -> one sample per (image, category) with all its boxes;
    sample id = smallest instance id of the group."""
    rng = rng or random.Random(0)
    categories = {c["id"]: c["name"] for c in instances_json["categories"]}
    images = {im["id"]: im for im in instances_json["images"]}
    grouped: Dict[tuple, Dict] = {}
    for anno in instances_json["annotations"]:
        key = (anno["image_id"], anno["category_id"])
        g = grouped.setdefault(key, {"boxes": [], "ids": []})
        g["boxes"].append(anno["bbox"])
        g["ids"].append(anno["id"])
    dataset = []
    for (image_id, category_id), g in grouped.items():
        name = categories[category_id]
        dataset.append({
            "query": rng.choice(DETECTION_TEMPLATES).format(name),
            "boxes": g["boxes"],
            "instance_ids": g["ids"],
            "category_id": category_id,
            "category_name": name,
            "image": {"subset": _subset_of(images[image_id]["file_name"]),
                      "image_id": image_id},
            "id": sorted(g["ids"])[0],
        })
    return dataset


def preprocess_classification(instances_json: Dict, rng=None) -> List[Dict]:
    """One sample per (image, category): the smallest-id box, answer = class
    name."""
    rng = rng or random.Random(0)
    categories = {c["id"]: c for c in instances_json["categories"]}
    images = {im["id"]: im for im in instances_json["images"]}
    grouped: Dict[tuple, List] = {}
    for anno in instances_json["annotations"]:
        grouped.setdefault((anno["image_id"], anno["category_id"]),
                           []).append((anno["bbox"], anno["id"]))
    dataset = []
    for (image_id, category_id), boxes in grouped.items():
        box, box_id = sorted(boxes, key=lambda x: x[1])[0]
        dataset.append({
            "query": rng.choice(CLASSIFICATION_TEMPLATES),
            "boxes": box,
            "instance_id": box_id,
            "category_id": category_id,
            "answer": categories[category_id]["name"],
            "image": {"subset": _subset_of(images[image_id]["file_name"]),
                      "image_id": image_id},
            "id": box_id,
        })
    return dataset


def preprocess_captions(captions_json: Dict, test: bool = False,
                        rng=None) -> List[Dict]:
    """One sample per caption annotation (or per image for test)."""
    rng = rng or random.Random(0)
    images = {im["id"]: im for im in captions_json["images"]}
    dataset = []
    if test:
        for im in captions_json["images"]:
            dataset.append({
                "query": rng.choice(CAPTION_TEMPLATES),
                "image": {"subset": _subset_of(im["file_name"]),
                          "image_id": im["id"]},
            })
        return dataset
    for cap in captions_json["annotations"]:
        im = images[cap["image_id"]]
        dataset.append({
            "query": rng.choice(CAPTION_TEMPLATES),
            "answer": cap["caption"],
            "cap_id": cap["id"],
            "image": {"subset": _subset_of(im["file_name"]),
                      "image_id": cap["image_id"]},
        })
    return dataset


def preprocess_vqa(questions_json: Dict,
                   annotations_json: Dict | None = None) -> List[Dict]:
    """One sample per question; with annotations: answer = multiple-choice
    answer, all_answers = Counter of 10 annotator answers + q/a types."""
    subset = questions_json["data_subtype"]
    annos = (annotations_json or {}).get("annotations")
    dataset = []
    for i, q in enumerate(questions_json["questions"]):
        sample = {
            "query": q["question"],
            "question_id": q["question_id"],
            "image": {"subset": subset, "image_id": q["image_id"]},
        }
        if annos is not None:
            anno = annos[i]
            assert (sample["question_id"] == anno["question_id"]
                    and q["image_id"] == anno["image_id"]), \
                "question-anno mismatch"
            sample["answer"] = anno["multiple_choice_answer"]
            sample["all_answers"] = dict(
                Counter(a["answer"] for a in anno["answers"]))
            sample["anno"] = {"question_type": anno["question_type"],
                              "answer_type": anno["answer_type"]}
        dataset.append(sample)
    return dataset


def dump_samples(samples: List[Dict], out_dir: str | Path, subset: str):
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{subset}.json").write_text(json.dumps(samples))
