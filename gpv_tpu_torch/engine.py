"""GPVEngine: the user-facing inference runtime (counterpart of
`gpv_tpu/engine.py`).

uint8 pixels -> normalise -> encode (ResNet / DETR / BERT / co-attention /
relevance) -> KV-cached greedy or beam decode -> relevance-sorted boxes,
on one device. The output contract matches `inference.py:24-47`:
`answer: str`, `boxes: (Q, 4)` normalised cxcywh sorted by relevance,
`relevance: (Q,)`; `predict_beam` that of `inference_beam_search.py`.

The engine runs on the card unless the caller asks for the CPU:
`device=None` means `cuda`, and without a CUDA device it raises.
"""
from __future__ import annotations

import copy
import threading
from typing import List, Optional

import numpy as np
import torch

from .decode.beam import beam_decode
from .decode.greedy import greedy_decode
from .models.gpv import GPV, build_gpv
from .ops.fold_bn import fold_frozen_bn
from .ops.image import normalize_image
from .text.vocab import AnswerVocab
from .text.wordpiece import WordPieceTokenizer
from .weights import StateDict, init_random


def resolve_device(device=None) -> torch.device:
    """`None` -> the current CUDA device; raises when there is none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("gpv_tpu_torch runs on a CUDA device and none is "
                           "available; pass device='cpu' to run on the CPU")
    return device


def encode_sorted(model: GPV, images_uint8, query_ids, query_valid,
                  image_valid=None):
    """uint8 (B,H,W,3) images and queries -> (memory, mem_valid, boxes
    (B,Q,4) fp32 and relevance (B,Q) fp32, both sorted by relevance, most
    relevant first). What every predict path runs before decoding; the
    export's encode program traces it."""
    images = normalize_image(images_uint8.float() / 255.0)
    memory, mem_valid, outputs = model.encode(
        images, query_ids.long(), image_valid, query_valid)
    rel = outputs["pred_relevance_logits"].float().softmax(-1)[..., 0]
    order = torch.argsort(-rel, dim=-1, stable=True)
    boxes = torch.take_along_dim(outputs["pred_boxes"].float(),
                                 order[..., None], dim=1)
    return memory, mem_valid, boxes, torch.take_along_dim(rel, order, 1)


class GPVEngine:
    def __init__(self, model: GPV, vocab: AnswerVocab,
                 tokenizer: WordPieceTokenizer, max_query_len: int = 20,
                 fold_bn: bool = True, device=None,
                 dtype: torch.dtype = torch.bfloat16):
        """Takes a copy of `model` with its weights: BN folded into the
        backbone convs (serving fold, on by default as in the JAX engine),
        cast to `dtype` and moved to `device`. The caller's model is left
        as it is; `load_weights` takes its weights again later."""
        self.device = resolve_device(device)
        self.fold_bn, self.dtype = fold_bn, dtype
        self.load_weights(model)
        self.vocab = vocab
        self.tokenizer = tokenizer
        # queries can never exceed the BERT position table
        self.max_query_len = min(max_query_len, model.bert_max_len)
        self._local = threading.local()

    def load_weights(self, model: GPV) -> None:
        """Serve `model`'s current weights: a fresh copy, BN folded, cast
        and moved as at construction. The trainer calls it before every
        in-train eval and visualisation; `model` itself is not touched
        (its BN stays unfolded)."""
        model = copy.deepcopy(model).eval().requires_grad_(False)
        for p in model.parameters():
            p.grad = None
        if self.fold_bn:
            fold_frozen_bn(model.detr.trunk)
        self.model = model.to(device=self.device, dtype=self.dtype)

    @property
    def last_decode_steps(self) -> int:
        """Decode steps of the calling thread's last `predict*` call: the
        server's worker threads share one engine."""
        return getattr(self._local, "steps", 0)

    @classmethod
    def from_config(cls, model_cfg, vocab: AnswerVocab,
                    tokenizer: WordPieceTokenizer,
                    state_dict: Optional[StateDict] = None,
                    dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                    max_query_len: int = 20, device=None) -> "GPVEngine":
        """Build the model from the `model` config node (`build_gpv`),
        with `state_dict` (reference names, loaded strictly) or, without
        one, seeded random weights (`weights.init_random`)."""
        model = build_gpv(model_cfg, vocab_size=len(vocab))
        if state_dict is None:
            init_random(model, seed)
        else:
            model.load_state_dict(state_dict, strict=True)
        return cls(model, vocab, tokenizer, max_query_len=max_query_len,
                   device=device, dtype=dtype)

    def _tensor(self, arr) -> Optional[torch.Tensor]:
        if arr is None:
            return None
        arr = np.ascontiguousarray(arr)
        if not arr.flags.writeable:  # e.g. np.asarray of a PIL image
            arr = arr.copy()
        return torch.from_numpy(arr).to(self.device)

    @torch.inference_mode()
    def _encode(self, images_uint8, query_ids, query_valid,
                image_valid=None):
        return encode_sorted(self.model, images_uint8, query_ids,
                             query_valid, image_valid)

    def _greedy(self, images, qids, qvalid, vocab_mask, image_valid=None):
        memory, mem_valid, boxes, rel = self._encode(images, qids, qvalid,
                                                     image_valid)
        tokens, _, steps = greedy_decode(self.model, memory, mem_valid,
                                         self.vocab.cls_id, vocab_mask,
                                         stop_id=self.vocab.stop_id)
        self._local.steps = steps
        return tokens.cpu().numpy(), boxes.cpu().numpy(), rel.cpu().numpy()

    def predict(self, images_uint8, queries: List[str],
                vocab_mask: Optional[np.ndarray] = None):
        """Batched greedy prediction.

        Args:
          images_uint8: (B, H, W, 3) uint8 (any fixed H, W per call).
          queries: list of B strings.

        Returns list of B dicts {answer, boxes, relevance}.
        """
        qids, qvalid = self.tokenizer.batch_encode(list(queries),
                                                   self.max_query_len)
        tokens, boxes, rel = self._greedy(
            self._tensor(images_uint8), self._tensor(qids),
            self._tensor(qvalid), self._tensor(vocab_mask))
        answers = self.vocab.decode_ids(tokens)
        return [{"answer": answers[i], "boxes": boxes[i],
                 "relevance": rel[i]} for i in range(len(queries))]

    def predict_native(self, images_uint8: List[np.ndarray],
                       queries: List[str],
                       vocab_mask: Optional[np.ndarray] = None,
                       bucket: int = 64):
        """Batched inference at native resolutions: images are grouped into
        shape buckets, each zero-padded up to the bucket's (H, W) (rounded
        up to multiples of `bucket`) with a validity mask."""
        def bshape(img):
            h, w = img.shape[:2]
            return (-(-h // bucket) * bucket, -(-w // bucket) * bucket)

        groups: dict = {}
        for i, img in enumerate(images_uint8):
            groups.setdefault(bshape(img), []).append(i)

        results: list = [None] * len(images_uint8)
        for (bh, bw), idxs in groups.items():
            batch = np.zeros((len(idxs), bh, bw, 3), np.uint8)
            valid = np.zeros((len(idxs), bh, bw), bool)
            for j, i in enumerate(idxs):
                h, w = images_uint8[i].shape[:2]
                batch[j, :h, :w] = images_uint8[i]
                valid[j, :h, :w] = True
            qids, qvalid = self.tokenizer.batch_encode(
                [queries[i] for i in idxs], self.max_query_len)
            tokens, boxes, rel = self._greedy(
                self._tensor(batch), self._tensor(qids),
                self._tensor(qvalid), self._tensor(vocab_mask),
                self._tensor(valid))
            answers = self.vocab.decode_ids(tokens)
            for j, i in enumerate(idxs):
                results[i] = {"answer": answers[j], "boxes": boxes[j],
                              "relevance": rel[j]}
        return results

    def predict_beam(self, images_uint8, queries: List[str],
                     beam_size: int = 5,
                     vocab_mask: Optional[np.ndarray] = None,
                     reference_quirks: bool = False):
        """Batched beam-search prediction; returns per sample {answers:
        [str x K], answer_probs: [float x K] (exp of the beam's fp32
        log-prob, in fp32 as in gpv_tpu, best first), boxes, relevance}
        (contract of `inference_beam_search.py:25-45`).

        reference_quirks=True reproduces the reference's beam tail bug (a
        phantom `vocab[0]` word after a beam that never emitted `__stop__`,
        `text.vocab.AnswerVocab.decode_beam_ids`) for string-level parity
        with upstream eval outputs; the default returns the clean decode.
        """
        qids, qvalid = self.tokenizer.batch_encode(list(queries),
                                                   self.max_query_len)
        memory, mem_valid, boxes, rel = self._encode(
            self._tensor(images_uint8), self._tensor(qids),
            self._tensor(qvalid))
        seqs, logp = beam_decode(self.model, memory, mem_valid,
                                 self.vocab.cls_id, beam_size,
                                 self._tensor(vocab_mask))
        self._local.steps = seqs.shape[-1]
        seqs = seqs.cpu().numpy()
        probs = np.exp(logp.cpu().numpy())
        boxes, rel = boxes.cpu().numpy(), rel.cpu().numpy()
        decode = (self.vocab.decode_beam_ids if reference_quirks
                  else self.vocab.decode_ids)
        return [{"answers": decode(seqs[i]),
                 "answer_probs": probs[i].tolist(),
                 "boxes": boxes[i], "relevance": rel[i]}
                for i in range(len(queries))]
