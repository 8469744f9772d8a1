"""GPVEngine: the user-facing inference runtime (counterpart of
`gpv_tpu/engine.py`).

uint8 pixels -> normalise -> encode (ResNet / DETR / BERT / co-attention /
relevance) -> KV-cached greedy decode -> relevance-sorted boxes, on one
device. The output contract matches `inference.py:24-47`: `answer: str`,
`boxes: (Q, 4)` normalised cxcywh sorted by relevance, `relevance: (Q,)`.

The engine runs on the card unless the caller asks for the CPU:
`device=None` means `cuda`, and without a CUDA device it raises.
"""
from __future__ import annotations

import copy
from typing import List, Optional

import numpy as np
import torch

from .decode.greedy import greedy_decode
from .models.gpv import GPV
from .ops.fold_bn import fold_frozen_bn
from .ops.image import normalize_image
from .text.vocab import AnswerVocab
from .text.wordpiece import WordPieceTokenizer


def resolve_device(device=None) -> torch.device:
    """`None` -> the current CUDA device; raises when there is none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("gpv_tpu_torch runs on a CUDA device and none is "
                           "available; pass device='cpu' to run on the CPU")
    return device


class GPVEngine:
    def __init__(self, model: GPV, vocab: AnswerVocab,
                 tokenizer: WordPieceTokenizer, max_query_len: int = 20,
                 fold_bn: bool = True, device=None,
                 dtype: torch.dtype = torch.bfloat16):
        """Takes a copy of `model` with its weights: BN folded into the
        backbone convs (serving fold, on by default as in the JAX engine),
        cast to `dtype` and moved to `device`. The caller's model is left
        as it is."""
        self.device = resolve_device(device)
        model = copy.deepcopy(model).eval().requires_grad_(False)
        if fold_bn:
            fold_frozen_bn(model.detr.trunk)
        self.model = model.to(device=self.device, dtype=dtype)
        self.vocab = vocab
        self.tokenizer = tokenizer
        # queries can never exceed the BERT position table
        self.max_query_len = min(max_query_len, model.bert_max_len)
        self.last_decode_steps = 0

    def _tensor(self, arr) -> Optional[torch.Tensor]:
        if arr is None:
            return None
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    @torch.inference_mode()
    def _encode(self, images_uint8, query_ids, query_valid,
                image_valid=None):
        images = normalize_image(images_uint8.float() / 255.0)
        memory, mem_valid, outputs = self.model.encode(
            images, query_ids.long(), image_valid, query_valid)
        rel = outputs["pred_relevance_logits"].float().softmax(-1)[..., 0]
        order = torch.argsort(-rel, dim=-1, stable=True)
        boxes = torch.take_along_dim(outputs["pred_boxes"].float(),
                                     order[..., None], dim=1)
        return memory, mem_valid, boxes, torch.take_along_dim(rel, order, 1)

    def _greedy(self, images, qids, qvalid, vocab_mask, image_valid=None):
        memory, mem_valid, boxes, rel = self._encode(images, qids, qvalid,
                                                     image_valid)
        tokens, _, steps = greedy_decode(self.model, memory, mem_valid,
                                         self.vocab.cls_id, vocab_mask,
                                         stop_id=self.vocab.stop_id)
        self.last_decode_steps = steps
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
