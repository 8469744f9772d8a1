"""CIDEr-D scorer (pycocoevalcap-compatible, pure Python); the port's
copy of `gpv_tpu/evaluation/cider.py`.

Behavior spec: pycocoevalcap `cider/cider_scorer.py` (n=4, sigma=6):
tf-idf n-gram vectors with document frequency over the evaluation corpus'
reference sets, count clipping (min(hyp, ref) * ref), per-order cosine
normalization, gaussian length penalty exp(-(lh-lr)^2 / (2*sigma^2)),
average over orders and references, x10. Includes the upstream quirk of
measuring 'length' by bigram count (len(tokens) - 1).
"""
from __future__ import annotations

import math
from collections import Counter, defaultdict


def _ngram_counts(tokens, n=4):
    out = Counter()
    for k in range(1, n + 1):
        for i in range(len(tokens) - k + 1):
            out[tuple(tokens[i:i + k])] += 1
    return out


def cider_d(refs: dict, hyps: dict, n: int = 4, sigma: float = 6.0) -> float:
    """refs/hyps: {key: [tokenized-string, ...]}; returns corpus CIDEr-D."""
    keys = list(hyps.keys())
    crefs = [[_ngram_counts(r.split(), n) for r in refs[k]] for k in keys]
    ctest = [_ngram_counts(hyps[k][0].split(), n) for k in keys]

    doc_freq = defaultdict(float)
    for ref_group in crefs:
        seen = set()
        for cnts in ref_group:
            seen.update(cnts.keys())
        for g in seen:
            doc_freq[g] += 1
    ref_len = math.log(float(max(len(crefs), 1)))

    def counts2vec(cnts):
        vec = [defaultdict(float) for _ in range(n)]
        norm = [0.0] * n
        length = 0
        for ngram, tf in cnts.items():
            df = math.log(max(1.0, doc_freq[ngram]))
            k = len(ngram) - 1
            vec[k][ngram] = float(tf) * (ref_len - df)
            norm[k] += vec[k][ngram] ** 2
            if k == 1:
                length += tf
        return vec, [math.sqrt(x) for x in norm], length

    def sim(vh, vr, nh, nr, lh, lr):
        delta = float(lh - lr)
        vals = [0.0] * n
        for k in range(n):
            for ngram, count in vh[k].items():
                vals[k] += min(count, vr[k][ngram]) * vr[k][ngram]
            if nh[k] != 0 and nr[k] != 0:
                vals[k] /= nh[k] * nr[k]
            vals[k] *= math.exp(-(delta ** 2) / (2 * sigma ** 2))
        return vals

    scores = []
    for test_cnts, ref_group in zip(ctest, crefs):
        vh, nh, lh = counts2vec(test_cnts)
        acc = [0.0] * n
        for ref_cnts in ref_group:
            vr, nr, lr = counts2vec(ref_cnts)
            vals = sim(vh, vr, nh, nr, lh, lr)
            for k in range(n):
                acc[k] += vals[k]
        score_avg = sum(acc) / n / max(len(ref_group), 1) * 10.0
        scores.append(score_avg)
    return float(sum(scores) / max(len(scores), 1))
