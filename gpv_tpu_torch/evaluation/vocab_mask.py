"""COCO-class vocab masks (the port's copy of
`gpv_tpu/evaluation/evaluators.py:coco_synonyms` and `coco_vocab_mask`).

`coco_synonyms.json` beside this file is the reference's 80 COCO classes
with their curated synonym lists (`data/coco/synonyms.py`), used for
classification answers and credit.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..text.treebank import word_tokenize

_SYN_PATH = Path(__file__).parent / "coco_synonyms.json"


def coco_synonyms() -> dict:
    """80 COCO classes -> synonym lists."""
    return json.loads(_SYN_PATH.read_text())


def coco_vocab_mask(vocab, use_syns: bool = False) -> np.ndarray:
    """Additive (V,) mask allowing the COCO class words (reference
    `create_coco_vocab_mask`, exp/gpv/metrics.py:122-144); with
    `use_syns`, every synonym's words too."""
    words = []
    for cls_name, syns in coco_synonyms().items():
        for phrase in (syns if use_syns else [cls_name]):
            words.extend(word_tokenize(phrase))
    return vocab.make_mask(words)
