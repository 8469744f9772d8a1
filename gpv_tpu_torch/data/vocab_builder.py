"""Answer-vocabulary builder (counterpart of
`gpv_tpu/data/vocab_builder.py`).

Behavior spec: reference `data/create_coco_vocab.py` — iterate every task
dataset's answers over train/val/test, Treebank-tokenize lowercased, keep
words with count > min_count (10), plus the 4 special tokens, sorted.

Note: the reference's count filter silently drops the special tokens (their
count is 0); the released vocab.json contains them, so here specials are
always kept — the behavior the rest of the reference requires.
"""
from __future__ import annotations

import json
from collections import Counter
from pathlib import Path
from typing import Iterable

from ..text.treebank import word_tokenize
from ..text.vocab import SPECIAL_TOKENS


def build_vocab(answers: Iterable[str], min_count: int = 10):
    """-> (sorted vocab list incl. specials, Counter of token counts)."""
    cnt = Counter()
    for answer in answers:
        for tok in word_tokenize(str(answer).lower()):
            cnt[tok] += 1
    selected = [w for w, c in cnt.items() if c > min_count]
    vocab = sorted(set(selected) | set(SPECIAL_TOKENS))
    _warn_uncovered_abbrevs(vocab)
    return vocab, cnt


def _warn_uncovered_abbrevs(vocab) -> list:
    """Corpus-reachability guard: the answer vocab is the only
    source of period-bearing tokens in model hypotheses, so any entry the
    PTB evaluator's abbreviation lexicon does NOT cover is a live caption-
    metric divergence vs CoreNLP — surface it at vocab-build time, where
    the real corpus is finally in hand, instead of silently at eval."""
    from ..evaluation.ptb import uncovered_period_tokens
    uncovered = uncovered_period_tokens(vocab)
    if uncovered:
        import logging
        logging.getLogger(__name__).warning(
            "answer vocab contains %d period-bearing token(s) outside the "
            "PTB abbreviation lexicon (caption-metric tokenization may "
            "split these where CoreNLP would not): %s — extend "
            "gpv_tpu_torch/evaluation/ptb.py _ABBREV for exact parity",
            len(uncovered), uncovered[:20])
    return uncovered


def iter_dataset_answers(learning_datasets_cfg, task_configs,
                         subsets=("train", "val", "test")):
    from ..datasets.coco import DATASET_CLASSES
    for subset in subsets:
        for cls_name, ds_cfg in learning_datasets_cfg.items():
            cfg = task_configs[ds_cfg.task_config]
            try:
                ds = DATASET_CLASSES[cls_name](cfg, subset, training=False)
            except FileNotFoundError:
                continue
            for s in ds.samples:
                if "answer" in s:
                    yield s["answer"]


def write_vocab(vocab, cnt, out_dir: str | Path):
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "vocab.json").write_text(json.dumps(vocab))
    (out / "vocab_count.json").write_text(json.dumps(dict(cnt)))
    return out / "vocab.json"
