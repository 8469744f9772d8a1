"""Corpus BLEU (pycocoevalcap-compatible, pure Python); the port's copy
of `gpv_tpu/evaluation/bleu.py`.

Behavior spec: pycocoevalcap `bleu/bleu_scorer.py` (Bleu(4)): corpus-level
modified n-gram precision with 'closest' reference-length brevity penalty,
tiny/small smoothing constants in the ratio, and the per-order score
aggregation used by `Bleu.compute_score` — returns corpus scores for n=1..4.
"""
from __future__ import annotations

from collections import Counter

import math

TINY = 1e-15
SMALL = 1e-9


def _ngrams(tokens, n):
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def bleu_corpus(refs: dict, hyps: dict, n: int = 4):
    """refs/hyps: {key: [tokenized-string, ...]} (hyps lists have 1 entry).

    Returns list of n corpus BLEU scores (BLEU1..BLEUn).
    """
    correct = [0] * n
    guess = [0] * n
    testlen = 0
    reflen = 0
    for k, hyp_list in hyps.items():
        hyp = hyp_list[0].split()
        ref_tok = [r.split() for r in refs[k]]
        testlen += len(hyp)
        # 'closest' reference length (ties -> shorter)
        lens = sorted((abs(len(r) - len(hyp)), len(r)) for r in ref_tok)
        reflen += lens[0][1] if lens else 0
        for i in range(n):
            hyp_ng = _ngrams(hyp, i + 1)
            max_ref = Counter()
            for r in ref_tok:
                for g, c in _ngrams(r, i + 1).items():
                    max_ref[g] = max(max_ref[g], c)
            guess[i] += max(0, len(hyp) - i)
            correct[i] += sum(min(c, max_ref.get(g, 0))
                              for g, c in hyp_ng.items())

    bleus = []
    logs = 0.0
    ratio = (testlen + TINY) / (reflen + SMALL)
    for i in range(n):
        logs += math.log(TINY + correct[i]) - math.log(SMALL + guess[i])
        score = math.exp(logs / (i + 1))
        if ratio < 1:
            score *= math.exp(1 - 1 / ratio)
        bleus.append(score)
    return bleus
