"""Answer-vocabulary embedding: the BERT CLS embedding of every vocab word
(counterpart of `gpv_tpu/data/vocab_embed.py`).

Reference `exp/gpv/compute_vocab_bert.py:8-29`: embed each word with BERT
and keep the CLS position -> `vocab_embed.npy` (V x 768), the fixed
matrix of the answer head. Words go through the port's `BertEncoder` in
batches of 16-token rows, so its attention runs on K1 (the tile kernel on
the card, Tq = Tk = 16, one launch a layer a batch).
"""
from __future__ import annotations

import copy
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..engine import resolve_device
from ..nn.bert import BertEncoder
from ..text.wordpiece import WordPieceTokenizer
from ..weights import init_random

WORD_TOKENS = 16  # [CLS] + word pieces + [SEP], padded


@torch.inference_mode()
def embed_vocab(vocab: list[str], tokenizer: WordPieceTokenizer,
                bert: Optional[BertEncoder] = None, batch_size: int = 256,
                device=None, dtype: torch.dtype = torch.float32
                ) -> np.ndarray:
    """-> (V, hidden) fp32 CLS embeddings.

    bert: the encoder with its weights (a copy runs on `device` in
    `dtype`); None means BERT-base with seeded random weights. device:
    None means the CUDA card."""
    device = resolve_device(device)
    if bert is None:
        bert = init_random(BertEncoder(), seed=0)
    bert = copy.deepcopy(bert).eval().to(device=device, dtype=dtype)
    outs = []
    for start in range(0, len(vocab), batch_size):
        ids, valid = tokenizer.batch_encode(vocab[start:start + batch_size],
                                            WORD_TOKENS)
        out = bert(torch.from_numpy(ids).long().to(device),
                   torch.from_numpy(valid).to(device))
        outs.append(out[:, 0].float().cpu().numpy())
    return np.concatenate(outs, axis=0).astype(np.float32)


def write_vocab_embed(embed: np.ndarray, out_path: str | Path) -> Path:
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    np.save(out_path, embed)
    return out_path
