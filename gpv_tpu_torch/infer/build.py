"""Engine construction from a composed config (counterpart of
`gpv_tpu/infer/build.py`), shared by the port's inference entry points
(`gpv_tpu_torch.cli.inference`, `inference_beam_search`, `serve_http`).
"""
from __future__ import annotations

from pathlib import Path

import torch

from ..engine import GPVEngine
from ..text.vocab import AnswerVocab
from ..text.wordpiece import WordPieceTokenizer
from ..weights import load_torch_state_dict

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_engine(cfg) -> GPVEngine:
    """Composed `exp/gpv[_inference]` config -> `GPVEngine`.

    Honours `ckpt` (a reference torch `.pth`, its names loaded strictly;
    null for seeded random weights; a missing path raises), `tpu.dtype`
    (bfloat16 or float32), `model.vocab` / `model.bert_vocab` (null: the
    debug vocabularies) and `device` (null: the CUDA card). An orbax
    checkpoint directory and `tpu.infer_data_parallel != 1` raise: the
    port reads no orbax without JAX, and runs on one card (ROADMAP).
    """
    vocab = (AnswerVocab.load(cfg.model.vocab) if cfg.model.get("vocab")
             else AnswerVocab.debug())
    bert_vocab = cfg.model.get("bert_vocab")
    tokenizer = (WordPieceTokenizer.load(bert_vocab) if bert_vocab
                 else WordPieceTokenizer.debug())
    tpu = cfg.get("tpu") or {}
    n_dp = int(tpu.get("infer_data_parallel", 1) or 1)
    if n_dp != 1:
        raise ValueError(
            f"tpu.infer_data_parallel={n_dp}: gpv_tpu_torch runs inference "
            "on one card; multi-card inference is not ported yet (ROADMAP "
            "Queue 1)")
    name = str(tpu.get("dtype", "bfloat16"))
    if name not in DTYPES:
        raise ValueError(f"tpu.dtype={name!r}: one of {sorted(DTYPES)}")

    state_dict = None
    ckpt = cfg.get("ckpt")
    if ckpt:
        path = Path(str(ckpt))
        if not path.exists():
            raise FileNotFoundError(
                f"checkpoint not found: {ckpt} (pass ckpt=<path to a "
                "reference model.pth>, or ckpt=null for random init)")
        if path.suffix != ".pth":
            raise NotImplementedError(
                f"ckpt={ckpt}: gpv_tpu_torch loads reference torch .pth "
                "checkpoints only; an orbax checkpoint of the JAX package "
                "cannot be read without JAX (ROADMAP Queue 1: orbax "
                "restore)")
        state_dict = load_torch_state_dict(path)
    return GPVEngine.from_config(cfg.model, vocab, tokenizer, state_dict,
                                 dtype=DTYPES[name],
                                 device=cfg.get("device"))
