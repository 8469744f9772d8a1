"""PTB caption tokenization (replacing pycocoevalcap's Java PTBTokenizer);
the port's copy of `gpv_tpu/evaluation/ptb.py`.

Behavior spec: pycocoevalcap `tokenizer/ptbtokenizer.py` shells out to
stanford-corenlp `PTBTokenizer -preserveLines -lowerCase`, then drops tokens
in a fixed PUNCTUATIONS list. Faithfully reproduced chain:

  1. sentence-aware tokenization: the Java tokenizer splits sentence-final
     periods mid-text ("a cat. a dog" -> "a cat . a dog") but keeps
     abbreviation periods attached ("mr. jones") via its lexicon; here a
     sentence pre-split + a small abbreviation list feed the framework's
     Treebank rules (`gpv_tpu_torch.text.treebank`).
  2. PTB3 bracket escaping THEN lowercasing: '(' -> '-LRB-' -> '-lrb-'.
  3. the punctuation strip compares against the UPPERCASE escape strings
     ("-LRB-" etc, ptbtokenizer.py PUNCTUATIONS), so the lowercased
     bracket escapes are NEVER stripped — reference tokenized captions
     really do contain '-lrb-' tokens. Reproduced verbatim (PARITY.md #6).
"""
from __future__ import annotations

import re

from ..text.treebank import word_tokenize

PUNCTUATIONS = {"''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
                ".", "?", "!", ",", ":", "-", "--", "...", ";"}

# PTB3 escapes, post-lowercase (the -lowerCase flag lowercases token text)
_BRACKETS = {"(": "-lrb-", ")": "-rrb-", "[": "-lsb-", "]": "-rsb-",
             "{": "-lcb-", "}": "-rcb-"}

# common abbreviations whose trailing period is NOT a sentence boundary
# (subset of the CoreNLP lexicon that can appear in caption text; round 5
# adds the months/days/ranks/corp-suffix classes from CoreNLP's kAbbrev —
# the full remaining CoreNLP lexicon is legal/financial jargon unreachable
# from picture-caption English)
_ABBREV = {"mr.", "mrs.", "ms.", "dr.", "prof.", "st.", "mt.", "jr.",
           "sr.", "vs.", "etc.", "inc.", "co.", "corp.", "no.", "dept.",
           "u.s.", "u.k.", "u.s.a.", "a.m.", "p.m.", "ft.", "in.", "oz.",
           "lb.", "lbs.", "ave.", "blvd.", "rd.",
           # months + days (CoreNLP abbreviates all of these)
           "jan.", "feb.", "mar.", "apr.", "jun.", "jul.", "aug.", "sep.",
           "sept.", "oct.", "nov.", "dec.",
           "mon.", "tue.", "tues.", "wed.", "thu.", "thurs.", "fri.",
           "sat.", "sun.",
           # titles/ranks
           "sgt.", "capt.", "lt.", "gen.", "col.", "maj.", "cmdr.",
           "adm.", "gov.", "sen.", "rep.", "rev.", "hon.", "pres.",
           # corporate/misc suffixes
           "bros.", "ltd.", "assn.", "univ.", "est.", "dist.", "mfg."}


def is_covered_abbrev(token: str) -> bool:
    """True iff a period-bearing token takes the abbreviation path here —
    vendored lexicon OR the generic single-letter-dotted class ("u.s.",
    "a.m.") that CoreNLP also recognizes structurally."""
    t = token.lower()
    return t in _ABBREV or bool(re.fullmatch(r"(\w\.)+", t))


def uncovered_period_tokens(words) -> list:
    """The corpus-reachability guard for PARITY #6's residual class: given
    vocabulary words (e.g. the trained answer vocab — the ONLY source of
    period-bearing tokens in model hypotheses), return those containing an
    interior '.' that would NOT take the abbreviation path, i.e. exactly
    the tokens on which this tokenizer could split a sentence where
    CoreNLP's larger lexicon would not. Empty list == the divergence class
    is unreachable from that corpus."""
    out = []
    for w in words:
        t = str(w).lower()
        # only tokens ENDING in '.' are sentence-boundary candidates: the
        # splitter fires on '.' + whitespace, so interior periods
        # (decimals "3.5") can never take the abbreviation path
        if t.endswith(".") and set(t) != {"."} and not is_covered_abbrev(t):
            out.append(t)
    return sorted(set(out))

_SENT_SPLIT = re.compile(r"(?<=[.!?])\s+")


def _sentences(text: str) -> list[str]:
    parts = _SENT_SPLIT.split(text)
    sents: list[str] = []
    for part in parts:
        prev = sents[-1].split()[-1].lower() if sents and sents[-1].split() \
            else None
        if prev is not None and is_covered_abbrev(prev):
            sents[-1] += " " + part  # "u.s. flag" is one sentence
        else:
            sents.append(part)
    return sents


def _protect_final_abbrev(sentence: str) -> str:
    """PTB3 period duplication: a sentence ending in an abbreviation keeps
    the abbreviation's period AND emits a sentence-final '.' token; adding
    the standalone '.' here keeps the Treebank final-period rule off the
    abbreviation ('a flag of the u.s.' -> 'u.s.' + '.')."""
    words = sentence.split()
    if words and is_covered_abbrev(words[-1]):
        return sentence + " ."
    return sentence


def ptb_tokenize_caption(caption: str) -> str:
    """One caption -> space-joined lowercased tokens minus punctuation."""
    text = caption.replace("\n", " ")
    toks = [t.lower() for s in _sentences(text)
            for t in word_tokenize(_protect_final_abbrev(s))]
    toks = [_BRACKETS.get(t, t) for t in toks]
    return " ".join(t for t in toks if t not in PUNCTUATIONS)


def ptb_tokenize(captions_for_image: dict) -> dict:
    """{key: [{'caption': str}, ...]} -> {key: [tokenized_str, ...]}
    (same contract as pycocoevalcap PTBTokenizer.tokenize)."""
    return {k: [ptb_tokenize_caption(c["caption"]) for c in v]
            for k, v in captions_for_image.items()}
