"""COCO-SCE split machinery (seen/unseen concept splits; counterpart of
`gpv_tpu/data/splits.py`).

Behavior spec: reference `data/coco/split_categories.py` (person + 39 random
shared / 10 held_from_vqa(=cap) / 30 held_from_det(=cls)),
`data/coco/split_images.py` (train2014 re-split by train_frac; val2014 ->
test) and `data/split_data_by_categories.py` (AssignCocoCategories:
lemmatized-synonym subsequence matching over query+answer with special-case
disambiguation for dog/bear/cup/orange/clock; train/val samples mentioning
unseen categories are dropped).

Divergence note: lemmatization is the EXACT WordNet morphy noun
algorithm over a vendored lexicon (`gpv_tpu_torch.data.morphy` — it
agrees with the reference's WordNetLemmatizer on every decision that can
touch the synonym table). The spaCy POS tag used by the orange/clock
special cases is a vendored word+local-context decision table
(`gpv_tpu_torch.data.pos_gate`) covering the closed query-template/COCO-answer/
caption domain the gate ever sees — see that module's docstring for the
rule-by-rule derivation and tests.
"""
from __future__ import annotations

import random
import re
from collections import Counter
from typing import Dict, List

from ..text.treebank import word_tokenize
from .morphy import build_lexicon, lemmatize_noun as lemmatize  # noqa: F401
from .pos_gate import any_orange_noun, any_watch_noun


def split_categories(categories: List[Dict], seed: int = 0,
                     num_shared: int = 40, num_held_from_vqa: int = 10):
    """80 COCO classes -> shared / held_from_vqa(=cap) / held_from_det(=cls).

    person is always shared; the rest is a seeded shuffle. The SCE split
    CLI calls this with its defaults (40/10/30), as the JAX package's does:
    `num_categories` of `configs/data/split_coco_categories.yaml` (60/10/10)
    is not read.
    """
    person = [c for c in categories if c["name"] == "person"]
    rest = [c for c in categories if c["name"] != "person"]
    rng = random.Random(seed)
    rng.shuffle(rest)
    shared = person + rest[:num_shared - 1]
    held_vqa = rest[num_shared - 1:num_shared - 1 + num_held_from_vqa]
    held_det = rest[num_shared - 1 + num_held_from_vqa:]
    return {
        "shared": shared,
        "held_from_vqa": held_vqa,
        "held_from_det": held_det,
        "held_from_cap": held_vqa,
        "held_from_cls": held_det,
    }


def split_images(image_ids: List[int], subset: str, subset_name: str,
                 train_frac: float = 0.9, seed: int = 0) -> Dict:
    """train2014 -> {train, val} by train_frac; val2014 -> test."""
    if subset == "train":
        ids = list(image_ids)
        rng = random.Random(seed)
        rng.shuffle(ids)
        n_train = int(len(ids) * train_frac)
        return {
            "train": {"subset": subset_name, "image_ids": ids[:n_train]},
            "val": {"subset": subset_name, "image_ids": ids[n_train:]},
        }
    return {"test": {"subset": subset_name, "image_ids": list(image_ids)}}


class AssignCocoCategories:
    """Tag a sample with the COCO categories its text mentions."""

    SPECIAL = ("orange", "dog", "cup", "clock", "bear")

    def __init__(self, categories: List[Dict], synonyms: Dict[str, List[str]]):
        self.categories = categories
        # lexicon closure over THIS synonym table (see morphy.py docstring)
        self._lexicon = build_lexicon(
            t for syns in synonyms.values() for s in syns
            for t in s.lower().replace("-", " ").split())
        self.synonyms = {
            name: [[self._lem(t) for t in word_tokenize(s)] for s in syns]
            for name, syns in synonyms.items()}

    def _lem(self, word: str) -> str:
        return lemmatize(word, self._lexicon)

    @staticmethod
    def _is_subsequence(needle, haystack):
        n = len(needle)
        return any(haystack[i:i + n] == needle
                   for i in range(len(haystack) - n + 1))

    def _remove_special(self, name: str, appearance: str,
                        tokens: List[str], text: str) -> bool:
        """True => discard this match (reference `remove_special`
        semantics, split_data_by_categories.py:44-95).

        `tokens` are the lemmatized match tokens (the dog/bear/cup gates
        run on these, as upstream); `text` is the RAW sample text — the
        orange/clock POS gates tokenize `text.lower()` themselves, like
        the reference's `nlp(text.lower())` (:76,:84), because plural/
        inflection morphology is POS evidence the lemmatizer destroys."""
        idxs = [i for i, w in enumerate(tokens) if w == appearance]
        # discard iff the FIRST appearance is preceded by the blocker word
        # (reference returns on the first index either way)
        if name == "dog":
            for i in idxs:
                return i > 0 and tokens[i - 1] == "hot"
            return False
        if name == "bear":
            for i in idxs:
                return i > 0 and tokens[i - 1] == "teddy"
            return False
        if name == "cup":
            if appearance in ("glass", "glasses") and "wine" in tokens:
                return True
            for i in idxs:
                return i > 0 and tokens[i - 1] in ("wear", "wearing")
            return False
        if name == "orange":
            # discard iff NO orange/oranges token is a noun (:75-82)
            return not any_orange_noun(word_tokenize(text.lower()))
        if name == "clock" and appearance in ("watch", "watches"):
            raw = word_tokenize(text.lower())
            if raw and raw[-1] in ("watch", "watches"):
                # sentence-FINAL "watch" -> KEEP the category (reference
                # :86-88 returns False before the POS scan)
                return False
            # discard iff NO watch/watches token is a noun (:88-94)
            return not any_watch_noun(raw)
        return False

    def assign(self, sample: Dict) -> List[Dict]:
        text = sample["query"]
        if "answer" in sample:
            text = text + " " + str(sample["answer"])
        tokens = [self._lem(w) for w in word_tokenize(text)]
        assigned = []
        for category in self.categories:
            for syn in self.synonyms.get(category["name"], []):
                if self._is_subsequence(syn, tokens):
                    if category["name"] in self.SPECIAL and \
                            self._remove_special(category["name"], syn[0],
                                                 tokens, text):
                        break
                    assigned.append(category)
                    break
        return assigned


def split_data_by_categories(samples: List[Dict], category_split: Dict,
                             dataset_name: str, subset: str,
                             image_split: Dict,
                             synonyms: Dict[str, List[str]]):
    """Assign seen/unseen tags and drop train/val samples mentioning unseen
    categories (reference `split_data`)."""
    if dataset_name in ("vqa", "coco_vqa", "coco_captions"):
        seen_groups = ("shared", "held_from_det")
        unseen_groups = ("held_from_vqa",)
    elif dataset_name in ("coco_detection", "coco_classification"):
        seen_groups = ("shared", "held_from_vqa")
        unseen_groups = ("held_from_det",)
    else:
        raise NotImplementedError(dataset_name)

    seen_cats = [c for g in seen_groups for c in category_split[g]]
    unseen_cats = [c for g in unseen_groups for c in category_split[g]]
    image_ids = set(image_split["image_ids"])
    img_subset = image_split["subset"]

    filtered = [s for s in samples
                if s["image"]["subset"] == img_subset
                and s["image"]["image_id"] in image_ids]

    seen_assigner = AssignCocoCategories(seen_cats, synonyms)
    unseen_assigner = AssignCocoCategories(unseen_cats, synonyms)
    kept, discarded = [], []
    for sample in filtered:
        sample = dict(sample)
        sample["coco_categories"] = {
            "seen": [c["name"] for c in seen_assigner.assign(sample)],
            "unseen": [c["name"] for c in unseen_assigner.assign(sample)],
        }
        if subset in ("train", "val") and sample["coco_categories"]["unseen"]:
            discarded.append(sample)
        else:
            kept.append(sample)

    counts = {"seen": Counter(), "unseen": Counter()}
    for s in kept:
        for c in s["coco_categories"]["seen"]:
            counts["seen"][c] += 1
        for c in s["coco_categories"]["unseen"]:
            counts["unseen"][c] += 1
    return kept, discarded, counts


def filter_instances_for_detr(instances_json: Dict, category_split: Dict,
                              image_split: Dict) -> Dict:
    """Filtered COCO instances JSON to pretrain DETR on the SCE split
    (reference `data/coco/create_coco_gpv_split_for_detectron.py`): keep
    images in the split, drop annotations of held_from_det categories."""
    held_ids = {c["id"] for c in category_split["held_from_det"]}
    image_ids = set(image_split["image_ids"])
    out = dict(instances_json)
    out["annotations"] = [
        a for a in instances_json["annotations"]
        if a["image_id"] in image_ids and a["category_id"] not in held_ids]
    out["images"] = [im for im in instances_json["images"]
                     if im["id"] in image_ids]
    return out
