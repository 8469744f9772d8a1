"""GPVEngine: the user-facing inference runtime (counterpart of
`gpv_tpu/engine.py`).

uint8 pixels -> normalise -> encode (ResNet / DETR / BERT / co-attention /
relevance) -> KV-cached greedy or beam decode -> relevance-sorted boxes,
on one device. The output contract matches `inference.py:24-47`:
`answer: str`, `boxes: (Q, 4)` normalised cxcywh sorted by relevance,
`relevance: (Q,)`; `predict_beam` that of `inference_beam_search.py`.

The engine runs on the card unless the caller asks for the CPU:
`device=None` means `cuda`, and without a CUDA device it raises.

Data-parallel inference (the JAX engine's `mesh=`, `gpv_tpu/engine.py:
31-61`): `devices=[...]` holds one folded replica of the weights per
device and splits every batch's rows over the devices, in order; a batch
whose size does not divide their number is padded by repeating its last
row, and the outputs are sliced back. Each device's shard runs on a
thread of its own: a plain loop over the devices would wait on each
shard's greedy loop (a host sync every step) before launching the next.
The threads share the interpreter lock, so the host work of the shards
adds up: a host-bound predict gains nothing from them (PERF.md §6).
A list may repeat a device (its shards then share one replica). With one
device the engine is the plain one-device engine.

Every call runs on CUDA streams of the calling thread's own, one a shard
(`ops.cuda_graph.own_stream`, slot k for shard k), after the work the
caller had queued on its current stream: the decode and the encode
capture CUDA graphs on the stream they run on (`ops.cuda_graph`). A
one-device engine's call does all of its work on the one stream.
"""
from __future__ import annotations

import contextlib
import copy
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch

from .decode.beam import beam_decode
from .decode.greedy import greedy_decode
from .models.gpv import GPV, build_gpv
from .ops.cuda_graph import own_stream
from .ops.fold_bn import fold_frozen_bn
from .ops.image import normalize_image
from .ops.stem_s2d import apply_stem_s2d
from .text.vocab import AnswerVocab
from .text.wordpiece import WordPieceTokenizer
from .utils.profiling import span
from .weights import StateDict, init_random


STEM = "detr.backbone.0.body.conv1.weight"


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
                 dtype: torch.dtype = torch.bfloat16,
                 devices: Optional[Sequence] = None):
        """Takes a copy of `model` with its weights: BN folded into the
        backbone convs (serving fold, on by default as in the JAX engine),
        cast to `dtype` and moved to `device`, or to each of `devices`
        (module docstring; `device` is then ignored). The caller's model
        is left as it is; `load_weights` takes its weights again later."""
        self.devices = [resolve_device(d)
                        for d in (devices if devices else [device])]
        self.device = self.devices[0]
        self.fold_bn, self.dtype = fold_bn, dtype
        self._local = threading.local()
        self.load_weights(model)
        self.vocab = vocab
        self.tokenizer = tokenizer
        # queries can never exceed the BERT position table
        self.max_query_len = min(max_query_len, model.bert_max_len)

    def load_weights(self, model: GPV) -> None:
        """Serve `model`'s current weights: a fresh copy, BN folded, cast
        and moved as at construction. The trainer calls it before every
        in-train eval and visualisation; `model` itself is not touched
        (its BN stays unfolded). Each device of a multi-device engine
        takes a replica."""
        model = copy.deepcopy(model).eval().requires_grad_(False)
        for p in model.parameters():
            p.grad = None
        if self.fold_bn:
            fold_frozen_bn(model.detr.trunk)
        distinct = list(dict.fromkeys(self.devices))
        replicas = {d: (model if i == 0 else copy.deepcopy(model)).to(
            device=d, dtype=self.dtype) for i, d in enumerate(distinct)}
        self.replicas = [replicas[d] for d in self.devices]
        self.model = self.replicas[0]
        if len(self.devices) > 1:  # the shards' streams read the copies
            for d in distinct:
                if d.type == "cuda":
                    torch.cuda.synchronize(d)

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
                    max_query_len: int = 20, device=None,
                    devices: Optional[Sequence] = None) -> "GPVEngine":
        """Build the model from the `model` config node (`build_gpv`),
        with `state_dict` (reference names, loaded strictly; a 7x7 stem
        is rewritten for `model.detr.stem_s2d`) or, without one, seeded
        random weights (`weights.init_random`)."""
        model = build_gpv(model_cfg, vocab_size=len(vocab))
        if state_dict is None:
            init_random(model, seed)
        else:
            if model.detr.trunk.stem_s2d and state_dict[STEM].shape[-1] == 7:
                state_dict = apply_stem_s2d(state_dict)
            model.load_state_dict(state_dict, strict=True)
        return cls(model, vocab, tokenizer, max_query_len=max_query_len,
                   device=device, dtype=dtype, devices=devices)

    @staticmethod
    def _tensor(arr, device) -> Optional[torch.Tensor]:
        if arr is None:
            return None
        arr = np.ascontiguousarray(arr)
        if not arr.flags.writeable:  # e.g. np.asarray of a PIL image
            arr = arr.copy()
        return torch.from_numpy(arr).to(device)

    def _shards(self, run, rows: list, n: int) -> tuple:
        """`run(k, *rows of shard k)` on every device, each tuple of numpy
        outputs concatenated over the shards and sliced to the first `n`
        rows; also the shards' decode steps (the `steps` each `run`
        returns last). `rows`: arrays (or None) with n leading rows."""
        D = len(self.devices)
        streams = {k: own_stream(d, k) for k, d in enumerate(self.devices)
                   if d.type == "cuda"}
        for k, stream in streams.items():
            stream.wait_stream(torch.cuda.current_stream(self.devices[k]))

        def shard(k, *part):
            with (torch.cuda.stream(streams[k]) if k in streams
                  else contextlib.nullcontext()):
                return run(k, *part)
        if D == 1:
            *out, steps = shard(0, *rows)
            return out, [steps]
        pad = (-n) % D
        per = (n + pad) // D
        rows = [None if a is None else np.concatenate(
            [a, np.repeat(a[-1:], pad, axis=0)]) for a in rows]
        with ThreadPoolExecutor(D, thread_name_prefix="gpv-shard") as pool:
            outs = list(pool.map(
                lambda k: shard(k, *(None if a is None
                                     else a[k * per:(k + 1) * per]
                                     for a in rows)), range(D)))
        return ([np.concatenate(parts)[:n]
                 for parts in list(zip(*outs))[:-1]], [o[-1] for o in outs])

    @torch.inference_mode()
    def _greedy_shard(self, k, images, qids, qvalid, vocab_mask,
                      image_valid=None):
        dev, model = self.devices[k], self.replicas[k]
        with span("engine.upload"):
            images, qids, qvalid, image_valid, vocab_mask = (
                self._tensor(a, dev) for a in (images, qids, qvalid,
                                               image_valid, vocab_mask))
        with span("engine.encode"):
            memory, mem_valid, boxes, rel = encode_sorted(
                model, images, qids, qvalid, image_valid)
        tokens, _, steps = greedy_decode(model, memory, mem_valid,
                                         self.vocab.cls_id, vocab_mask,
                                         stop_id=self.vocab.stop_id)
        with span("engine.fetch"):
            return (tokens.cpu().numpy(), boxes.cpu().numpy(),
                    rel.cpu().numpy(), steps)

    def _greedy(self, images, qids, qvalid, vocab_mask, image_valid=None):
        """Greedy prediction of host rows: (tokens, boxes, rel) numpy."""
        (tokens, boxes, rel), steps = self._shards(
            lambda k, *r: self._greedy_shard(k, *r[:3], vocab_mask, r[3]),
            [np.asarray(images), qids, qvalid, image_valid], len(qids))
        self._local.steps = max(steps)
        self._local.shard_steps = steps
        return tokens, boxes, rel

    @property
    def last_shard_steps(self) -> list:
        """Each shard's decode steps in the calling thread's last
        `predict*` call (one entry for a one-device engine)."""
        return list(getattr(self._local, "shard_steps", []))

    def predict(self, images_uint8, queries: List[str],
                vocab_mask: Optional[np.ndarray] = None):
        """Batched greedy prediction.

        Args:
          images_uint8: (B, H, W, 3) uint8 (any fixed H, W per call).
          queries: list of B strings.

        Returns list of B dicts {answer, boxes, relevance}.
        """
        with span("engine.tokenize"):
            qids, qvalid = self.tokenizer.batch_encode(list(queries),
                                                       self.max_query_len)
        tokens, boxes, rel = self._greedy(images_uint8, qids, qvalid,
                                          vocab_mask)
        with span("engine.detokenize"):
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
            tokens, boxes, rel = self._greedy(batch, qids, qvalid,
                                              vocab_mask, valid)
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

        @torch.inference_mode()
        def run(k, images, qids, qvalid):
            dev, model = self.devices[k], self.replicas[k]
            memory, mem_valid, boxes, rel = encode_sorted(
                model, self._tensor(images, dev), self._tensor(qids, dev),
                self._tensor(qvalid, dev))
            seqs, logp = beam_decode(model, memory, mem_valid,
                                     self.vocab.cls_id, beam_size,
                                     self._tensor(vocab_mask, dev))
            return (seqs.cpu().numpy(), logp.cpu().numpy(),
                    boxes.cpu().numpy(), rel.cpu().numpy(), seqs.shape[-1])

        (seqs, logp, boxes, rel), steps = self._shards(
            run, [np.asarray(images_uint8), qids, qvalid], len(qids))
        self._local.steps = max(steps)
        self._local.shard_steps = steps
        probs = np.exp(logp)
        decode = (self.vocab.decode_beam_ids if reference_quirks
                  else self.vocab.decode_ids)
        return [{"answers": decode(seqs[i]),
                 "answer_probs": probs[i].tolist(),
                 "boxes": boxes[i], "relevance": rel[i]}
                for i in range(len(queries))]
