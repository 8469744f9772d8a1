"""Engine construction from a composed config (counterpart of
`gpv_tpu/infer/build.py`), shared by the port's inference entry points
(`gpv_tpu_torch.cli.inference`, `inference_beam_search`, `serve_http`).
"""
from __future__ import annotations

from pathlib import Path

import torch

from ..engine import GPVEngine, resolve_device
from ..text.vocab import AnswerVocab
from ..text.wordpiece import WordPieceTokenizer
from ..weights import load_torch_state_dict, orbax_refusal

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def infer_devices(n_dp, device=None) -> list:
    """`tpu.infer_data_parallel` -> the engine's devices, as
    `gpv_tpu/infer/build.py:43-56` resolves it: N of this host's devices
    of `device`'s type (the CUDA cards, or the one CPU), -1 all of them.
    One device (N of 0, 1, or -1 on a host with one card or on the CPU)
    gives `[device]`, the plain one-device engine; N above the local
    count raises."""
    n_dp = int(n_dp or 1)
    dev = resolve_device(device)
    local = ([torch.device("cuda", i)
              for i in range(torch.cuda.device_count())]
             if dev.type == "cuda" else [dev])
    n = len(local) if n_dp < 0 else n_dp
    if n > len(local):
        raise ValueError(
            f"tpu.infer_data_parallel={n_dp} but only {len(local)} local "
            f"devices are visible ({dev.type})")
    return [dev] if n <= 1 else local[:n]


def build_engine(cfg) -> GPVEngine:
    """Composed `exp/gpv[_inference]` config -> `GPVEngine`.

    Honours `ckpt` (null for seeded random weights; a missing path
    raises; else any file `weights.load_torch_state_dict` reads, its names
    loaded strictly: a reference `.pth`, a bare state dict, or the
    trainer's own `ckpts/model` / `ckpts/last`, whatever the file's name),
    `tpu.dtype` (bfloat16 or float32), `model.vocab` / `model.bert_vocab`
    (null: the debug vocabularies), `device` (null: the CUDA card) and
    `tpu.infer_data_parallel` (split every batch over N local cards, -1
    all; `infer_devices`). A directory (an orbax checkpoint of the JAX
    package) raises: the port reads no orbax (convert it with
    `convert_orbax_checkpoint.py`).
    """
    vocab = (AnswerVocab.load(cfg.model.vocab) if cfg.model.get("vocab")
             else AnswerVocab.debug())
    bert_vocab = cfg.model.get("bert_vocab")
    tokenizer = (WordPieceTokenizer.load(bert_vocab) if bert_vocab
                 else WordPieceTokenizer.debug())
    tpu = cfg.get("tpu") or {}
    devices = infer_devices(tpu.get("infer_data_parallel", 1),
                            cfg.get("device"))
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
        if path.is_dir():
            raise NotImplementedError(orbax_refusal(path))
        state_dict = load_torch_state_dict(path)
    return GPVEngine.from_config(cfg.model, vocab, tokenizer, state_dict,
                                 dtype=DTYPES[name], devices=devices)
