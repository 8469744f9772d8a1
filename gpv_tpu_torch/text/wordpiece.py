"""WordPiece tokenizer for the BERT query encoder (host-side, no HF deps).

The port's own copy of `gpv_tpu/text/wordpiece.py` (host-only, no framework);
the port imports nothing of `gpv_tpu`.

Behavior spec: HF `BertTokenizer.from_pretrained('bert-base-uncased')` as used
by the reference (`exp/gpv/models/bert.py:8`): BasicTokenizer (lowercase,
accent-strip, punctuation split, CJK isolation) + greedy longest-match-first
WordPiece with '##' continuations, [CLS]/[SEP] wrapping, [PAD] to batch max.
Loads a standard `vocab.txt`; a deterministic fallback vocab keeps the
pipeline runnable in environments without the file (tests, benchmarks).
"""
from __future__ import annotations

import unicodedata
from pathlib import Path

import numpy as np

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or \
            (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


def basic_tokenize(text: str, lowercase: bool = True) -> list[str]:
    # clean + CJK spacing
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or unicodedata.category(ch).startswith("C") \
                and ch not in "\t\n\r":
            continue
        if _is_cjk(cp):
            out.append(f" {ch} ")
        elif ch in "\t\n\r" or unicodedata.category(ch) == "Zs":
            out.append(" ")
        else:
            out.append(ch)
    tokens = "".join(out).split()

    split_tokens = []
    for tok in tokens:
        if lowercase:
            tok = tok.lower()
            tok = "".join(c for c in unicodedata.normalize("NFD", tok)
                          if unicodedata.category(c) != "Mn")
        cur = []
        for ch in tok:
            if _is_punctuation(ch):
                if cur:
                    split_tokens.append("".join(cur))
                    cur = []
                split_tokens.append(ch)
            else:
                cur.append(ch)
        if cur:
            split_tokens.append("".join(cur))
    return split_tokens


class WordPieceTokenizer:
    def __init__(self, vocab: list[str], lowercase: bool = True,
                 max_chars_per_word: int = 100):
        self.vocab = list(vocab)
        self.token_to_id = {t: i for i, t in enumerate(self.vocab)}
        self.lowercase = lowercase
        self.max_chars_per_word = max_chars_per_word
        for s in (PAD, UNK, CLS, SEP):
            if s not in self.token_to_id:
                raise ValueError(f"vocab missing {s}")
        self.pad_id = self.token_to_id[PAD]
        self.unk_id = self.token_to_id[UNK]
        self.cls_id = self.token_to_id[CLS]
        self.sep_id = self.token_to_id[SEP]

    @classmethod
    def load(cls, vocab_path: str | Path) -> "WordPieceTokenizer":
        words = Path(vocab_path).read_text().splitlines()
        return cls([w.rstrip("\n") for w in words])

    @classmethod
    def debug(cls) -> "WordPieceTokenizer":
        """Character-level fallback vocab (ascii letters/digits as pieces)."""
        vocab = [PAD, UNK, CLS, SEP, MASK]
        chars = "abcdefghijklmnopqrstuvwxyz0123456789'?.,-!"
        vocab += list(chars) + [f"##{c}" for c in chars]
        return cls(vocab)

    def wordpiece(self, word: str) -> list[str]:
        if len(word) > self.max_chars_per_word:
            return [UNK]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.token_to_id:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [UNK]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> list[str]:
        out = []
        for tok in basic_tokenize(text, self.lowercase):
            out.extend(self.wordpiece(tok))
        return out

    def encode(self, text: str) -> list[int]:
        return ([self.cls_id]
                + [self.token_to_id.get(t, self.unk_id)
                   for t in self.tokenize(text)]
                + [self.sep_id])

    def batch_encode(self, texts: list[str], max_len: int | None = None):
        """-> (ids (B,T) int32, valid (B,T) bool), padded to batch max or
        the static `max_len` (truncating long queries)."""
        encoded = [self.encode(t) for t in texts]
        T = max(len(e) for e in encoded)
        if max_len is not None:
            T = max_len
            # truncation keeps the final [SEP] (HF BertTokenizer
            # semantics) — BERT never saw a [CLS] ... sequence without it
            encoded = [e[:T - 1] + [self.sep_id] if len(e) > T else e
                       for e in encoded]
        ids = np.full((len(texts), T), self.pad_id, np.int32)
        valid = np.zeros((len(texts), T), bool)
        for i, e in enumerate(encoded):
            ids[i, :len(e)] = e
            valid[i, :len(e)] = True
        return ids, valid
