"""Serving bundles: an engine's programs exported ahead of time, reloaded
without the model code (counterpart of `gpv_tpu/export.py`).

`export_engine` writes a bundle directory:
- `manifest.json`: the format version, image size, query length, vocab
  size, batch buckets, each program, both vocabularies, the decoder's
  cache shape, the torch version, the dtype and the device;
- `weights.pt`: the engine's folded weights, stored once;
- per batch bucket B, two `torch.export` programs that take the weights as
  inputs (so no program carries a copy of them):
  - `encode_b{B}.pt2`: uint8 images and query ids/validity -> the decode
    memory state (each decoder layer's cross-attention K/V, the answer
    classifier, the memory validity) and the relevance-sorted boxes and
    relevance;
  - `step_b{B}.pt2`: one KV-cached greedy decode step, with the position
    `t` a 0-d tensor input (one program serves every step) and the caches
    written in place.

`ExportedEngine(bundle_dir)` serves `predict` with `GPVEngine.predict`'s
contract. It imports no model code (`gpv_tpu_torch.models`, `nn`,
`weights`, `infer`): only the attention ops (`gpv::fused_attention`,
`gpv::fused_biattention`, which the programs call), `torch.export.load`,
the vocabulary and the tokenizer. It runs the greedy loop on the host,
with `decode/greedy.py`'s early stop and the vocab mask added to the
logits there, so one set of programs serves masked and unmasked requests
and a predict launches the kernels as often as `GPVEngine.predict` does
for the same steps. This differs from the JAX bundle, which exports the
whole `while_loop` twice a bucket (masked and unmasked): the early stop
depends on the data, which a traced program cannot branch on.

Programs replay the traced graph operator by operator (no compilation);
they are tied to the device they were exported on.
"""
from __future__ import annotations

import json
import threading
import time
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

MANIFEST = "manifest.json"
WEIGHTS = "weights.pt"
FORMAT_VERSION = 1
# the model's top-level modules and buffers a decode step reads
STEP_MODULES = ("text_decoder", "answer_input_embedings", "answer_head",
                "pos_enc_table")


class _Encode(nn.Module):
    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, images, query_ids, query_valid):
        # model code, imported where a program is traced: never by
        # ExportedEngine
        from .engine import encode_sorted
        memory, mem_valid, boxes, rel = encode_sorted(
            self.model, images, query_ids, query_valid)
        mem_kvs, classifier = self.model.precompute_text_memory(memory)
        return {"mem_kvs": mem_kvs, "classifier": classifier,
                "mem_valid": mem_valid, "boxes": boxes, "relevance": rel}


class _Step(nn.Module):
    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, token, t, mem_kvs, classifier, mem_valid, caches):
        return self.model.text_step(token, (mem_kvs, classifier), mem_valid,
                                    caches, t)


class _Program(nn.Module):
    """The exported root: `body` run on weights given as the first input.
    The root registers no parameter, so the program stores none."""

    def __init__(self, body: nn.Module):
        super().__init__()
        self.__dict__["body"] = body  # not a submodule: no parameters

    def forward(self, weights, *args):
        return torch.func.functional_call(self.body, weights, args)


def _export(body, weights, args, path: Path) -> float:
    """Export `body` over (weights, *args) to `path`; its seconds. Fails if
    the program kept a weight of its own (one it read from the model
    rather than from its inputs); small constants the code makes (the
    image normalisation's mean and std) stay in the program."""
    t0 = time.perf_counter()
    ep = torch.export.export(_Program(body), (weights, *args))
    kept = [v for v in (*ep.state_dict.values(), *ep.constants.values())
            if isinstance(v, torch.Tensor)]
    ptrs = {w.untyped_storage().data_ptr() for w in weights.values()}
    if sum(v.nbytes for v in kept) > 2 ** 16 or any(
            v.untyped_storage().data_ptr() in ptrs for v in kept):
        raise RuntimeError(f"{path.name} holds weights of its own: "
                           f"{[tuple(v.shape) for v in kept]}")
    ep.example_inputs = None  # else the save writes the weights with them
    torch.export.save(ep, path)
    return time.perf_counter() - t0


def export_engine(engine, out_dir, batch_sizes: Sequence[int] = (1, 8, 20),
                  image_hw=(480, 640)) -> dict:
    """Write `engine`'s bundle (module docstring) to `out_dir`, for each
    batch size, on the engine's device and dtype. Returns the manifest."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    model, dev = engine.model, engine.device
    H, W = int(image_hw[0]), int(image_hw[1])
    T = engine.max_query_len
    weights = {**dict(model.named_parameters()),
               **dict(model.named_buffers())}
    step_names = [k for k in weights if k.split(".")[0] in STEP_MODULES]
    enc_w = {f"model.{k}": v for k, v in weights.items()}
    step_w = {f"model.{k}": weights[k] for k in step_names}
    dec = model.text_decoder
    cache = (model.max_text_len, dec.num_heads, dec.dim // dec.num_heads)
    sizes = sorted({int(b) for b in batch_sizes})
    programs = {}
    with torch.no_grad():
        for B in sizes:
            qids, qvalid = engine.tokenizer.batch_encode(["export"] * B, T)
            images = torch.zeros(B, H, W, 3, dtype=torch.uint8, device=dev)
            args = (images, torch.from_numpy(qids).long().to(dev),
                    torch.from_numpy(qvalid).to(dev))
            name = f"encode_b{B}"
            secs = _export(_Encode(model), enc_w, args, out / f"{name}.pt2")
            programs[name] = {"kind": "encode", "batch": B,
                              "export_s": secs}
            state = _Encode(model)(*args)
            caches = tuple(
                (torch.zeros(B, *cache, dtype=engine.dtype, device=dev),
                 torch.zeros(B, *cache, dtype=engine.dtype, device=dev))
                for _ in dec.layers)
            args = (torch.full((B,), engine.vocab.cls_id, dtype=torch.long,
                               device=dev),
                    torch.zeros((), dtype=torch.long, device=dev),
                    state["mem_kvs"], state["classifier"],
                    state["mem_valid"], caches)
            name = f"step_b{B}"
            secs = _export(_Step(model), step_w, args, out / f"{name}.pt2")
            programs[name] = {"kind": "step", "batch": B, "export_s": secs}
    torch.save({k: v.detach() for k, v in weights.items()}, out / WEIGHTS)
    manifest = {
        "format_version": FORMAT_VERSION,
        "image_hw": [H, W],
        "max_query_len": T,
        "vocab_size": len(engine.vocab),
        "batch_sizes": sizes,
        "programs": programs,
        "step_weights": step_names,
        "cache": {"layers": len(dec.layers), "shape": list(cache)},
        "answer_vocab": list(engine.vocab.words),
        "wordpiece_vocab": list(engine.tokenizer.vocab),
        "torch_version": torch.__version__,
        "dtype": str(engine.dtype).split(".")[-1],
        "device": dev.type,
    }
    (out / MANIFEST).write_text(json.dumps(manifest))
    return manifest


def _device(device) -> torch.device:
    """`None` -> the current CUDA device; raises when there is none (the
    policy of `engine.resolve_device`, which imports the model)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("gpv_tpu_torch runs on a CUDA device and none is "
                           "available; pass device='cpu' to run on the CPU")
    return device


class ExportedEngine:
    """Serving runtime over an `export_engine` bundle (module docstring).
    `predict` matches `GPVEngine.predict`, padding a partial batch by
    repetition up to the smallest exported bucket that fits. Runs on the
    card unless `device` says otherwise; the bundle must have been
    exported on a device of that type."""

    def __init__(self, bundle_dir, device=None):
        from . import ops  # noqa: F401  (registers the gpv:: ops)
        from .text.vocab import AnswerVocab
        from .text.wordpiece import WordPieceTokenizer

        self.dir = Path(bundle_dir)
        self.manifest = m = json.loads((self.dir / MANIFEST).read_text())
        if m.get("format_version") != FORMAT_VERSION:
            raise ValueError(f"unsupported bundle format "
                             f"{m.get('format_version')}")
        self.device = _device(device)
        if self.device.type != m["device"]:
            raise ValueError(f"{self.dir} was exported on {m['device']}; "
                             f"its programs cannot run on {self.device}: "
                             "export again on that device")
        self.vocab = AnswerVocab(m["answer_vocab"])
        self.tokenizer = WordPieceTokenizer(m["wordpiece_vocab"])
        self.max_query_len = int(m["max_query_len"])
        self.image_hw = tuple(m["image_hw"])
        self.batch_sizes = [int(b) for b in m["batch_sizes"]]
        self.dtype = getattr(torch, m["dtype"])
        weights = torch.load(self.dir / WEIGHTS, map_location=self.device,
                             weights_only=True)
        self._weights = {
            "encode": {f"model.{k}": v for k, v in weights.items()},
            "step": {f"model.{k}": weights[k] for k in m["step_weights"]}}
        self._programs = {
            (p["kind"], int(p["batch"])):
                torch.export.load(self.dir / f"{name}.pt2").module()
            for name, p in m["programs"].items()}
        self._cache_layers = int(m["cache"]["layers"])
        self._cache_shape = tuple(m["cache"]["shape"])
        self._positions = [torch.tensor(t, device=self.device)
                           for t in range(self._cache_shape[0] - 1)]
        self._local = threading.local()

    @property
    def last_decode_steps(self) -> int:
        """Decode steps of the calling thread's last `predict`."""
        return getattr(self._local, "steps", 0)

    def _bucket(self, n: int) -> int:
        for b in self.batch_sizes:
            if b >= n:
                return b
        raise ValueError(f"batch of {n} exceeds the largest exported bucket "
                         f"{self.batch_sizes[-1]}")

    def _greedy(self, B: int, state: dict, vocab_mask):
        """`decode/greedy.py`'s loop over the step program: (B, T-1) ids."""
        step, w = self._programs["step", B], self._weights["step"]
        dev = self.device
        caches = tuple(
            (torch.zeros(B, *self._cache_shape, dtype=self.dtype, device=dev),
             torch.zeros(B, *self._cache_shape, dtype=self.dtype, device=dev))
            for _ in range(self._cache_layers))
        stop = self.vocab.stop_id
        tok = torch.full((B,), self.vocab.cls_id, dtype=torch.long,
                         device=dev)
        tokens = torch.full((B, len(self._positions)), stop,
                            dtype=torch.int32, device=dev)
        stopped = torch.zeros(B, dtype=torch.bool, device=dev)
        steps = 0
        for t, pos in enumerate(self._positions):
            steps += 1
            logits = step(w, tok, pos, state["mem_kvs"], state["classifier"],
                          state["mem_valid"], caches)
            if vocab_mask is not None:
                logits = logits + vocab_mask
            tok = logits.argmax(-1)
            tokens[:, t] = tok
            stopped |= tok == stop
            if bool(stopped.all()):
                break
        self._local.steps = steps
        return tokens

    def predict(self, images_uint8, queries: List[str],
                vocab_mask: Optional[np.ndarray] = None):
        """Batched greedy prediction: (n, H, W, 3) uint8 at the bundle's
        image size and n queries -> n dicts {answer, boxes, relevance}."""
        images = np.asarray(images_uint8)
        n = len(queries)
        if images.shape[1:3] != self.image_hw:
            raise ValueError(f"exported for images {self.image_hw}, got "
                             f"{images.shape[1:3]}: resize on the client "
                             "or export again")
        B = self._bucket(n)
        if B != n:  # pad by repetition: one program per bucket
            images = np.stack([images[i % n] for i in range(B)])
            queries = [queries[i % n] for i in range(B)]
        qids, qvalid = self.tokenizer.batch_encode(list(queries),
                                                   self.max_query_len)
        dev = self.device
        with torch.inference_mode():
            state = self._programs["encode", B](
                self._weights["encode"],
                torch.from_numpy(np.ascontiguousarray(images)).to(dev),
                torch.from_numpy(qids).long().to(dev),
                torch.from_numpy(qvalid).to(dev))
            mask = None if vocab_mask is None else torch.as_tensor(
                np.asarray(vocab_mask, np.float32), device=dev)
            tokens = self._greedy(B, state, mask).cpu().numpy()
            boxes = state["boxes"].cpu().numpy()
            rel = state["relevance"].cpu().numpy()
        answers = self.vocab.decode_ids(tokens)
        return [{"answer": answers[i], "boxes": boxes[i],
                 "relevance": rel[i]} for i in range(n)]
