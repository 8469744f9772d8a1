"""Answer vocabulary: encoding targets and decoding model outputs (host-side).

The port's own copy of `gpv_tpu/text/vocab.py` (host-only, no framework);
the port imports nothing of `gpv_tpu`.

Behavior spec: reference `GPV.encode_answers` (`exp/gpv/models/gpv.py:377-430`)
— generation mode builds `__cls__ {answer} __stop__`, Treebank-tokenized,
lowercased, OOV -> `__unk__`, padded with `__pad__`, truncated to
`max_text_len`; classification mode is the pair `[__cls__, answer]`.
Decoding mirrors `inference.py:24-47` / `token_ids_to_words` (`gpv.py:432`):
read words until `__stop__`/`__pad__`.

The 4 special tokens and their order follow `data/create_coco_vocab.py:44-49`
(specials appended AFTER the sorted word list).
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .treebank import detokenize, word_tokenize

PAD, CLS, STOP, UNK = "__pad__", "__cls__", "__stop__", "__unk__"
SPECIAL_TOKENS = (PAD, CLS, STOP, UNK)


class AnswerVocab:
    def __init__(self, words: list[str]):
        for s in SPECIAL_TOKENS:
            if s not in words:
                raise ValueError(f"vocab missing special token {s}")
        self.words = list(words)
        self.word_to_idx = {w: i for i, w in enumerate(self.words)}
        self.pad_id = self.word_to_idx[PAD]
        self.cls_id = self.word_to_idx[CLS]
        self.stop_id = self.word_to_idx[STOP]
        self.unk_id = self.word_to_idx[UNK]

    def __len__(self):
        return len(self.words)

    @classmethod
    def load(cls, path: str | Path) -> "AnswerVocab":
        return cls(json.loads(Path(path).read_text()))

    @classmethod
    def debug(cls, extra_words: list[str] | None = None,
              size: int = 128) -> "AnswerVocab":
        """Tiny vocab for tests/benchmarks when no vocab.json is configured."""
        words = ["a", "the", "man", "dog", "cat", "horse", "person", "red",
                 "blue", "green", "two", "three", "yes", "no", "on", "in",
                 "riding", "sitting", "standing", "white", "black", ".", ","]
        if extra_words:
            for w in extra_words:
                if w not in words:
                    words.append(w)
        while len(words) < size - len(SPECIAL_TOKENS):
            words.append(f"w{len(words)}")
        return cls(words + list(SPECIAL_TOKENS))

    def encode_answers(self, answers: list[str], max_text_len: int = 20,
                       answering_type: str = "generation") -> np.ndarray:
        """List of answer strings ('' allowed) -> (B, S) int32 padded ids.

        S is static = max_text_len for generation (the reference pads to the
        batch max; fixed length keeps XLA shapes static — extra positions are
        `__pad__` which the losses already down-weight identically since the
        reference never masked pad CE anyway, see losses.py pad_idx: null).
        """
        if answering_type == "classification":
            ids = np.full((len(answers), 2), self.unk_id, np.int32)
            ids[:, 0] = self.cls_id
            for i, ans in enumerate(answers):
                ids[i, 1] = self.word_to_idx.get(ans, self.unk_id)
            return ids
        if answering_type != "generation":
            raise NotImplementedError(answering_type)

        ids = np.full((len(answers), max_text_len), self.pad_id, np.int32)
        for i, ans in enumerate(answers):
            sent = f"{CLS} {STOP}" if ans == "" else f"{CLS} {ans} {STOP}"
            toks = [w.lower() for w in word_tokenize(sent)]
            toks = toks[:max_text_len]
            for j, w in enumerate(toks):
                ids[i, j] = self.word_to_idx.get(w, self.unk_id)
        return ids

    def decode_ids(self, token_ids) -> list[str]:
        """(B, S) generated ids (no leading cls) -> detokenized strings."""
        out = []
        for row in np.asarray(token_ids):
            words = []
            for tid in row:
                w = self.words[int(tid)]
                if w in (STOP, PAD):
                    break
                if w == CLS:
                    continue
                words.append(w)
            out.append(detokenize(words))
        return out

    def decode_beam_ids(self, token_ids) -> list[str]:
        """(B, S) beam ids -> strings, with the reference beam tail quirk.

        Reference `beam_decode_text` zero-fills a `max_text_len`-slot seq
        buffer but only generates `max_text_len - 1` tokens; its final
        detokenization loop (`exp/gpv/models/gpv.py:316-327`) then reads one
        slot past the last generated step, so a beam that never emitted
        __stop__/__pad__ gets the phantom word `vocab[0]` appended (the
        released vocab is `sorted()`, data/create_coco_vocab.py:47, so
        index 0 is a real token, not a special). Reproduced here for
        string-level parity; greedy decode has no such quirk.
        """
        out = []
        for row in np.asarray(token_ids):
            words = []
            stopped = False
            for tid in row:
                w = self.words[int(tid)]
                if w in (STOP, PAD):
                    stopped = True
                    break
                if w == CLS:
                    continue
                words.append(w)
            if not stopped:
                words.append(self.words[0])
            out.append(detokenize(words))
        return out

    def token_ids_to_words(self, token_ids) -> list[list[str]]:
        return [[self.words[int(t)] for t in row]
                for row in np.asarray(token_ids)]

    def make_mask(self, allowed_words: list[str],
                  specials: tuple = (STOP, PAD)) -> np.ndarray:
        """Additive vocab mask: 0 for allowed words + `specials`, -10000 else.

        Matches `create_coco_vocab_mask` (`exp/gpv/metrics.py:122-144`),
        which only unmasks __stop__/__pad__ among the specials.
        """
        mask = np.full((len(self.words),), -10000.0, np.float32)
        for w in allowed_words:
            idx = self.word_to_idx.get(w)
            if idx is not None:
                mask[idx] = 0.0
        for s in specials:
            mask[self.word_to_idx[s]] = 0.0
        return mask
