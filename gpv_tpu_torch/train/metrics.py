"""Train-time evaluation metrics on a subsample (counterpart of
`gpv_tpu/train/metrics.py`).

Reference `exp/gpv/metrics.py`: per-task greedy-decode loops capped at
`training.num_val_samples[task]`: VQA soft accuracy, captioning Bleu/Cider
through the caption evaluator, classification accuracy with the synonym
vocab mask, and detection/refexp per-sample AP. Every task runs
`GPVEngine.predict`; the APs are computed in memory.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..evaluation.evaluators import CocoCaptioning as CapEvaluator
from ..evaluation.vocab_mask import coco_synonyms, coco_vocab_mask
from ..evaluation.voc_ap import voc_ap
from ..infer.predictions import iter_padded_batches


def _predicted(engine, dataset, batch_size, max_samples, num_workers,
               vocab_mask=None):
    """(item, prediction) of each real sample, batch by batch."""
    for items, n_real in iter_padded_batches(dataset, batch_size,
                                              max_samples,
                                              num_workers=num_workers):
        outs = engine.predict(np.stack([it["image"] for it in items]),
                              [it["query"] for it in items], vocab_mask)
        yield from zip(items[:n_real], outs[:n_real])


def vqa_accuracy(engine, dataset, batch_size: int, max_samples: int,
                 num_workers: int = 0) -> float:
    correct = total = 0
    for it, out in _predicted(engine, dataset, batch_size, max_samples,
                              num_workers):
        answers = it["sample"].get("all_answers", {})
        if out["answer"] in answers:
            correct += min(answers[out["answer"]] / 3, 1)
        total += 1
    return round(correct / (total + 1e-6), 4)


def cls_metrics(engine, dataset, batch_size: int, max_samples: int,
                num_workers: int = 0) -> Dict:
    syn = coco_synonyms()
    mask = coco_vocab_mask(engine.vocab, use_syns=True)
    correct = total = 0
    for it, out in _predicted(engine, dataset, batch_size, max_samples,
                              num_workers, mask):
        gt = it["sample"]["answer"]
        if out["answer"] in syn.get(gt, [gt]):
            correct += 1
        total += 1
    return {"accuracy": round(correct / (total + 1e-6), 4)}


def cap_metrics(engine, dataset, batch_size: int, max_samples: int,
                num_workers: int = 0) -> Dict:
    predictions, used_samples = {}, []
    for it, out in _predicted(engine, dataset, batch_size, max_samples,
                              num_workers):
        sample = it["sample"]
        used_samples.append(sample)
        predictions[str(sample["cap_id"])] = {"answer": out["answer"]}
    if not predictions:
        return {"Bleu4": 0, "Cider": 0}
    return CapEvaluator(used_samples, predictions).evaluate()["scores"]


def _box_map(engine, dataset, batch_size: int, max_samples: int,
             num_workers: int = 0) -> float:
    """Mean per-sample VOC AP of the predicted boxes against the GT."""
    aps = []
    for it, out in _predicted(engine, dataset, batch_size, max_samples,
                              num_workers):
        if "boxes" not in it:
            continue
        # normalised cxcywh -> xywh, predictions and GT alike
        pred = np.asarray(out["boxes"], np.float64).copy()
        pred[:, :2] -= 0.5 * pred[:, 2:]
        gt = np.asarray(it["boxes"], np.float64).copy()
        gt[:, :2] -= 0.5 * gt[:, 2:]
        aps.append(voc_ap(pred, np.asarray(out["relevance"]), gt))
    return float(np.mean(aps)) if aps else 0.0


def det_metrics(engine, dataset, batch_size, max_samples,
                num_workers: int = 0) -> Dict:
    return {"mAP": _box_map(engine, dataset, batch_size, max_samples,
                            num_workers)}


def refexp_metrics(engine, dataset, batch_size, max_samples,
                   num_workers: int = 0) -> Dict:
    return {"mAP": _box_map(engine, dataset, batch_size, max_samples,
                            num_workers)}
