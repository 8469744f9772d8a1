"""Dataset index + statistics helpers (counterpart of
`gpv_tpu/data/index.py`).

Behavior spec: reference `data/create_index.py:13` (image -> sample index
across tasks) and `data/data_stats.py:5` (per-split sample counts).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List


def create_image_index(task_samples: Dict[str, List[dict]]) -> Dict:
    """{task: samples} -> {'{subset}_{image_id}': {task: [sample indices]}}"""
    index: Dict[str, Dict[str, list]] = defaultdict(lambda: defaultdict(list))
    for task, samples in task_samples.items():
        for i, s in enumerate(samples):
            key = f"{s['image']['subset']}_{s['image']['image_id']}"
            index[key][task].append(i)
    return {k: dict(v) for k, v in index.items()}


def data_stats(task_samples: Dict[str, Dict[str, List[dict]]]) -> Dict:
    """{task: {subset: samples}} -> counts of samples + unique images."""
    stats: Dict[str, Dict] = {}
    for task, subsets in task_samples.items():
        stats[task] = {}
        for subset, samples in subsets.items():
            images = {(s["image"]["subset"], s["image"]["image_id"])
                      for s in samples}
            stats[task][subset] = {"num_samples": len(samples),
                                   "num_images": len(images)}
    return stats
