"""Penn-Treebank-style word tokenizer/detokenizer (pure Python, host-side).

The port's own copy of `gpv_tpu/text/treebank.py` (host-only, no framework);
the port imports nothing of `gpv_tpu`.

Behavior spec: the reference calls `nltk.word_tokenize` when encoding answers
(`exp/gpv/models/gpv.py:409`) and `TreebankWordDetokenizer` when turning
decoded token ids back into strings (`exp/gpv/metrics.py:52`). The NLTK data
files aren't shippable here, so the framework carries its own implementation
of the classic Treebank rules (punctuation splitting, contractions, quote
directionality). The rule set is the standard published sed-script behavior;
outputs match `nltk.tokenize.word_tokenize` on the vocabulary GPV deals with
(lowercase COCO answers/captions/questions).
"""
from __future__ import annotations

import re

# --- tokenizer rules (applied in order) -------------------------------------
_STARTING_QUOTES = [
    (re.compile(r"^\""), r"``"),
    (re.compile(r"(``)"), r" \1 "),
    (re.compile(r"([ \(\[{<])(\"|\'{2})"), r"\1 `` "),
]
_PUNCTUATION = [
    (re.compile(r"([:,])([^\d])"), r" \1 \2"),
    (re.compile(r"([:,])$"), r" \1 "),
    (re.compile(r"\.\.\."), r" ... "),
    (re.compile(r"[;@#$%&]"), r" \g<0> "),
    (re.compile(r'([^\.])(\.)([\]\)}>"\']*)\s*$'), r"\1 \2\3 "),
    (re.compile(r"[?!]"), r" \g<0> "),
    (re.compile(r"([^'])' "), r"\1 ' "),
]
_PARENS_BRACKETS = [(re.compile(r"[\]\[\(\)\{\}<>]"), r" \g<0> ")]
_DOUBLE_DASHES = [(re.compile(r"--"), r" -- ")]
_ENDING_QUOTES = [
    (re.compile(r'"'), " '' "),
    (re.compile(r"(\S)(\'\')"), r"\1 \2 "),
    (re.compile(r"([^' ])('[sS]|'[mM]|'[dD]|') "), r"\1 \2 "),
    (re.compile(r"([^' ])('ll|'LL|'re|'RE|'ve|'VE|n't|N'T) "), r"\1 \2 "),
]
# MacIntyre contraction patterns (nltk's CONTRACTIONS2/3 verbatim). The
# `(?#X)` marker is a no-op regex COMMENT for the tokenizer (matches
# "cannot" -> "can not") and is replaced with `\s` for the DETOKENIZER
# (matches "can not" -> "cannot"), exactly as nltk compiles its variants.
_CONTRACTION_PATTERNS2 = [
    r"(?i)\b(can)(?#X)(not)\b",
    r"(?i)\b(d)(?#X)('ye)\b",
    r"(?i)\b(gim)(?#X)(me)\b",
    r"(?i)\b(gon)(?#X)(na)\b",
    r"(?i)\b(got)(?#X)(ta)\b",
    r"(?i)\b(lem)(?#X)(me)\b",
    r"(?i)\b(more)(?#X)('n)\b",
    r"(?i)\b(wan)(?#X)(na)(?=\s)",
]
_CONTRACTION_PATTERNS3 = [
    r"(?i) ('t)(?#X)(is)\b",
    r"(?i) ('t)(?#X)(was)\b",
]
_CONTRACTIONS = [re.compile(p)
                 for p in _CONTRACTION_PATTERNS2 + _CONTRACTION_PATTERNS3]
_DETOK_CONTRACTIONS = [re.compile(p.replace("(?#X)", r"\s"))
                       for p in (_CONTRACTION_PATTERNS3
                                 + _CONTRACTION_PATTERNS2)]


def word_tokenize(text: str) -> list[str]:
    """Treebank word tokenization of one sentence."""
    for regexp, substitution in _STARTING_QUOTES:
        text = regexp.sub(substitution, text)
    for regexp, substitution in _PUNCTUATION:
        text = regexp.sub(substitution, text)
    for regexp, substitution in _PARENS_BRACKETS:
        text = regexp.sub(substitution, text)
    for regexp, substitution in _DOUBLE_DASHES:
        text = regexp.sub(substitution, text)
    text = " " + text + " "
    for regexp, substitution in _ENDING_QUOTES:
        text = regexp.sub(substitution, text)
    for regexp in _CONTRACTIONS:
        text = regexp.sub(r" \1 \2 ", text)
    return text.split()


# --- detokenizer rules (inverse direction; nltk TreebankWordDetokenizer
# rule lists, applied in its order) ------------------------------------------
_DETOK_ENDING_QUOTES = [
    (re.compile(r"([^' ])\s('ll|'LL|'re|'RE|'ve|'VE|n't|N'T) "), r"\1\2 "),
    (re.compile(r"([^' ])\s('[sS]|'[mM]|'[dD]|') "), r"\1\2 "),
    # exclude single quote from attaching '' (nltk #3260)
    (re.compile(r"([^'\s])\s(\'\')"), r"\1\2"),
    (re.compile(r"([,.;:!?'])\s+(\"|\'\')"), r"\1\2"),
    (re.compile(r"(\'\')\s([.,:)\]>};%])"), r"\1\2"),
    (re.compile(r"''"), '"'),
    (re.compile(r'([,.;:!?])"(\')'), r"\1\2" '"'),
]
_DETOK_PUNCT = [
    (re.compile(r"([^'])\s'\s"), r"\1' "),
    (re.compile(r"\s([?!])"), r"\g<1>"),
    (re.compile(r'([^\.])\s(\.)([\]\)}>"\']*)\s*$'), r"\1\2\3"),
    (re.compile(r"([#$])\s"), r"\g<1>"),
    (re.compile(r"\s([;%])"), r"\g<1>"),
    (re.compile(r"\s\.\.\.\s"), r"..."),
    # keep right pad after comma/colon before non-digits
    (re.compile(r"\s([:,])\s([^\d])"), r"\1 \2"),
]
_DETOK_PARENS = [
    (re.compile(r"([\[\(\{\<])\s"), r"\g<1>"),
    (re.compile(r"\s([\]\)\}\>])"), r"\g<1>"),
    (re.compile(r"([\]\)\}\>])\s([:;,.])"), r"\1\2"),
]
_DETOK_STARTING_QUOTES = [
    (re.compile(r"([ (\[{<])\s``"), r"\1``"),
    (re.compile(r"(``)\s"), r"\1"),
    (re.compile(r"``"), r'"'),
]


def detokenize(tokens: list[str]) -> str:
    """Inverse of `word_tokenize` (nltk TreebankWordDetokenizer rules,
    applied in its exact order)."""
    # pad like nltk so end-of-string contractions/clitics match the
    # trailing-space-anchored rules ("does n't" sentence-final)
    text = " " + " ".join(tokens) + " "
    for regexp in _DETOK_CONTRACTIONS:
        text = regexp.sub(r"\1\2", text)
    for regexp, substitution in _DETOK_ENDING_QUOTES:
        text = regexp.sub(substitution, text)
    text = text.strip()
    text = re.sub(r" -- ", "--", text)
    for regexp, substitution in _DETOK_PARENS:
        text = regexp.sub(substitution, text)
    for regexp, substitution in _DETOK_PUNCT:
        text = regexp.sub(substitution, text)
    for regexp, substitution in _DETOK_STARTING_QUOTES:
        text = regexp.sub(substitution, text)
    return text.strip()
