"""Per-task offline evaluators (counterpart of
`gpv_tpu/evaluation/evaluators.py`; same API and semantics as the
reference).

Behavior spec: `exp/gpv/evaluators.py` — each evaluator takes
(samples, predictions, boxes) where `predictions[k] = {'answer': str}` and
`boxes[k] = {'boxes': (N,4) cxcywh normalized, 'relevance': (N,)}` (an h5py
group in the reference; any mapping with those keys works here), keyed by the
task id field; `.evaluate(novelty)` filters by the sample's
coco_categories.unseen list for the gpv_split novelty subsets.
"""
from __future__ import annotations

from collections import Counter

import numpy as np

from .bleu import bleu_corpus
from .cider import cider_d
from .ptb import ptb_tokenize
from .vocab_mask import coco_synonyms
from .voc_ap import voc_ap

TASK_TO_ID_FIELD = {
    "CocoVqa": "question_id",
    "CocoClassification": "id",
    "CocoCaptioning": "cap_id",
    "CocoDetection": "id",
    "RefCocop": "sent_id",
}


class CocoEvalBase:
    task = "Generic"

    def __init__(self, samples, predictions, boxes=None):
        field = TASK_TO_ID_FIELD[self.task]
        self.sample_list = samples
        self.samples = {str(s[field]): s for s in samples}
        self.predictions = predictions
        self.boxes = boxes

    def sample_novelty(self, sample):
        if len(sample.get("coco_categories", {}).get("unseen", [])) > 0:
            return "held_out_concepts"
        return "seen_concepts"

    def _keep(self, sample, novelty):
        return novelty == "everything" or self.sample_novelty(sample) == novelty


class CocoVqa(CocoEvalBase):
    task = "CocoVqa"

    def evaluate(self, novelty="everything"):
        absent = 0
        correct = {"all": 0, "answer_type": Counter(),
                   "question_type": Counter()}
        total = {"all": 0, "answer_type": Counter(),
                 "question_type": Counter()}
        for k, sample in self.samples.items():
            if not self._keep(sample, novelty):
                continue
            if k not in self.predictions:
                absent += 1
                continue
            pred = self.predictions[k]["answer"].lower()
            gt = {a.lower(): f for a, f in sample["all_answers"].items()}
            a_type = sample["anno"]["answer_type"]
            q_type = sample["anno"]["question_type"]
            if pred in gt:
                c = min(gt[pred] / 3, 1)
                correct["all"] += c
                correct["answer_type"][a_type] += c
                correct["question_type"][q_type] += c
            total["all"] += 1
            total["answer_type"][a_type] += 1
            total["question_type"][q_type] += 1
        eps = 1e-6
        accuracy = {
            "all": round(100 * correct["all"] / (eps + total["all"]), 2),
            "answer_type": {
                a: round(100 * correct["answer_type"][a]
                         / (eps + total["answer_type"][a]), 2)
                for a in total["answer_type"]},
            "question_type": {
                a: round(100 * correct["question_type"][a]
                         / (eps + total["question_type"][a]), 2)
                for a in total["question_type"]},
        }
        return {"correct": correct, "total": total, "absent": absent,
                "accuracy": accuracy}


class CocoClassification(CocoEvalBase):
    task = "CocoClassification"

    def evaluate(self, novelty="everything"):
        syn = coco_synonyms()
        absent = 0
        correct, total = Counter(), Counter()
        overall_correct = overall_total = 0
        for k, sample in self.samples.items():
            if not self._keep(sample, novelty):
                continue
            if k not in self.predictions:
                absent += 1
                continue
            pred = self.predictions[k]["answer"].lower()
            if pred in syn[sample["answer"]]:
                overall_correct += 1
                correct[sample["answer"]] += 1
            overall_total += 1
            total[sample["answer"]] += 1
        eps = 1e-6
        return {
            "correct": correct, "overall_correct": overall_correct,
            "total": total, "overall_total": overall_total, "absent": absent,
            "accuracy": {c: round(correct[c] / (eps + total[c]), 4)
                         for c in total},
            "overall_accuracy": round(
                overall_correct / (eps + overall_total), 4),
        }


class CocoCaptioning(CocoEvalBase):
    task = "CocoCaptioning"

    def __init__(self, samples, predictions, boxes=None):
        super().__init__(samples, predictions, boxes)
        self.imgid_to_caps = {}
        for s in samples:
            key = (f"{s['image']['subset']}_"
                   f"{str(s['image']['image_id']).zfill(12)}")
            self.imgid_to_caps.setdefault(key, []).append(
                s["answer"].lower())

    def evaluate(self, novelty="everything"):
        absent = 0
        refs, hyps = {}, {}
        for k, sample in self.samples.items():
            if not self._keep(sample, novelty):
                continue
            if k not in self.predictions:
                absent += 1
                continue
            key = (f"{sample['image']['subset']}_"
                   f"{str(sample['image']['image_id']).zfill(12)}")
            cap_id = sample["cap_id"]
            refs[cap_id] = [{"caption": c} for c in self.imgid_to_caps[key]]
            hyps[cap_id] = [
                {"caption": self.predictions[k]["answer"].lower()}]

        metrics = {"absent": absent, "total": len(hyps), "scores": {}}
        if not hyps:
            for i in range(4):
                metrics["scores"][f"Bleu{i + 1}"] = 0
            metrics["scores"]["Cider"] = 0
            return metrics
        refs_t = ptb_tokenize(refs)
        hyps_t = ptb_tokenize(hyps)
        bleus = bleu_corpus(refs_t, hyps_t, 4)
        for i, s in enumerate(bleus):
            metrics["scores"][f"Bleu{i + 1}"] = s
        metrics["scores"]["Cider"] = cider_d(refs_t, hyps_t)
        return metrics


class _BoxEvalBase(CocoEvalBase):
    def evaluate(self, novelty="everything", iou_thresh=0.5):
        absent = 0
        total = Counter()
        aps = []
        for k, sample in self.samples.items():
            if not self._keep(sample, novelty):
                continue
            if k not in self.predictions:
                absent += 1
                continue
            entry = self.boxes[k]
            scores = np.asarray(entry["relevance"][()])
            pred = np.asarray(entry["boxes"][()], np.float64).copy()
            # cxcywh -> xywh (still normalized)
            pred[:, 0] -= 0.5 * pred[:, 2]
            pred[:, 1] -= 0.5 * pred[:, 3]
            gt = np.asarray(sample["boxes"], np.float64).reshape(-1, 4).copy()
            W, H = sample["image"]["W"], sample["image"]["H"]
            gt[:, 0] /= W
            gt[:, 1] /= H
            gt[:, 2] /= W
            gt[:, 3] /= H
            aps.append(voc_ap(pred, scores, gt, iou_thresh))
            total["all"] += 1
            if "category_name" in sample:
                total[sample["category_name"]] += 1
        return {"absent": absent, "total": total,
                "mAP": float(np.mean(aps)) if aps else 0.0}


class CocoDetection(_BoxEvalBase):
    task = "CocoDetection"


class RefCocop(_BoxEvalBase):
    task = "RefCocop"


EVALUATOR_CLASSES = {
    "CocoVqa": CocoVqa,
    "CocoClassification": CocoClassification,
    "CocoCaptioning": CocoCaptioning,
    "CocoDetection": CocoDetection,
    "RefCocop": RefCocop,
}
