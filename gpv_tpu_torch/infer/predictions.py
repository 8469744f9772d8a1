"""Offline batched prediction + evaluation pipeline (counterpart of
`gpv_tpu/infer/predictions.py`).

Behavior spec: reference `exp/gpv/compute_predictions.py` — batched greedy
decode (classification adds the COCO class-name vocab mask, use_syns=False),
boxes+relevance sorted by relevance to HDF5 groups keyed by sample id,
answers to `{task}_{split}_{subset}_predictions.json`, then per-novelty
evaluator runs into `..._metrics.json`; det/refexp samples get image W/H
attached first (`update_samples_with_image_size`).

`predict_dataset` is the loop over a dataset and keeps its results in
memory; `make_predictions` writes them as the JAX package's files. PIL and
h5py are imported where they are used, so the in-memory path needs
neither.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np

from ..datasets.loader import take_shared_block, to_shared_block
from ..evaluation.evaluators import EVALUATOR_CLASSES, TASK_TO_ID_FIELD
from ..evaluation.vocab_mask import coco_vocab_mask

LOADERS = ("threads", "processes")


def iter_padded_batches(dataset, batch_size: int, max_samples=None,
                        num_workers: int = 0, prefetch: int = 2,
                        loader: str = "threads"):
    """Yield (items, n_real) with len(items) == batch_size for EVERY batch.

    The final partial batch is padded by repeating its last item — the same
    policy as `serve.py` — so every engine call of a dataset has one batch
    shape.

    num_workers > 1 loads items on a worker pool with a `prefetch`-batch
    lookahead, overlapping host image decode/resize with device compute
    (reference eval uses a num_workers dataloader, train_distr.py:213-222;
    this is the eval-side `eval.num_workers`). `loader` picks the pool
    (`eval.loader`):

    - "threads": ThreadPoolExecutor. PIL/numpy release the GIL for the
      heavy work, so this scales with cores when the GIL-held share per
      item is small.
    - "processes": fork-based ProcessPoolExecutor, one BATCH per task;
      workers stack the batch's images into a SharedMemory block and send
      only its name + the light fields over the pipe, so the uint8 pixels
      are never pickled. The parent copies the images out of the block
      and frees the block at once, so no yielded item views shared
      memory. Workers run `dataset.get` only (numpy), never torch or CUDA,
      so forking a parent that has launched kernels is safe; fork start
      means the dataset need not be picklable.

    Each item draws from its own index-seeded RandomState, so results are
    identical for ANY worker count/order/pool kind.
    """
    n = len(dataset) if max_samples is None else min(len(dataset),
                                                     max_samples)
    starts = list(range(0, n, batch_size))

    def load_item(i):
        return dataset.get(i, np.random.RandomState(i))

    def pad(items):
        n_real = len(items)
        while len(items) < batch_size:
            items.append(items[-1])
        return items, n_real

    if loader not in LOADERS:
        raise ValueError(f"eval.loader must be threads|processes, "
                         f"got {loader!r}")
    if loader == "processes" and num_workers and int(num_workers) > 1:
        yield from _iter_batches_procs(dataset, starts, n, batch_size,
                                       int(num_workers),
                                       max(1, int(prefetch)), pad)
    elif num_workers and int(num_workers) > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(int(num_workers)) as pool:
            depth = max(1, int(prefetch))
            pending = [
                [pool.submit(load_item, i)
                 for i in range(s, min(s + batch_size, n))]
                for s in starts[:depth]]
            for bi in range(len(starts)):
                futs = pending.pop(0)
                if bi + depth < len(starts):
                    s = starts[bi + depth]
                    pending.append(
                        [pool.submit(load_item, i)
                         for i in range(s, min(s + batch_size, n))])
                yield pad([f.result() for f in futs])
    else:
        for start in starts:
            yield pad([load_item(i)
                       for i in range(start, min(start + batch_size, n))])


# ---- process-pool batch loading (eval.loader=processes) ----

_PROC_DATASET = None  # set in each forked worker by _proc_init


def _proc_init(dataset):
    global _PROC_DATASET
    _PROC_DATASET = dataset


def _proc_load_range(s, e):
    """Load items [s, e) in a worker; return (shm meta, light items).

    The batch's images are stacked into ONE shared-memory block
    (`datasets.loader.to_shared_block`) and stripped from the item dicts,
    so only the block's name plus the light fields cross the pipe; the
    parent takes the block over and unlinks it."""
    items = [_PROC_DATASET.get(i, np.random.RandomState(i))
             for i in range(s, e)]
    if not items or "image" not in items[0]:
        return None, items
    return to_shared_block(np.stack([it.pop("image") for it in items])), \
        items


def _iter_batches_procs(dataset, starts, n, batch_size, num_workers,
                        prefetch, pad):
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    if "fork" not in mp.get_all_start_methods():
        raise RuntimeError(
            "eval.loader=processes needs the fork start method (workers "
            "inherit the dataset without pickling); use loader=threads "
            "on this platform")
    ctx = mp.get_context("fork")

    def attach(meta, items):
        """The images, copied out of the worker's block (then unlinked)."""
        if meta is not None:
            images = take_shared_block(meta)
            for j, it in enumerate(items):
                it["image"] = images[j]
        return items

    pending = []
    with ProcessPoolExecutor(num_workers, mp_context=ctx,
                             initializer=_proc_init,
                             initargs=(dataset,)) as pool:
        try:
            depth = num_workers + prefetch
            pending = [pool.submit(_proc_load_range, s,
                                   min(s + batch_size, n))
                       for s in starts[:depth]]
            for bi in range(len(starts)):
                meta, items = pending.pop(0).result()
                if bi + depth < len(starts):
                    s = starts[bi + depth]
                    pending.append(pool.submit(_proc_load_range, s,
                                               min(s + batch_size, n)))
                yield pad(attach(meta, items))
        finally:
            # a consumer abandoning the generator mid-epoch leaves
            # worker-created blocks (ownership already transferred to
            # this process) orphaned in /dev/shm — drain and unlink
            for f in pending:
                try:
                    meta, _ = f.result()
                    if meta is not None:
                        take_shared_block(meta)
                except Exception:
                    pass


def update_samples_with_image_size(image_dir, samples):
    from PIL import Image

    from ..datasets.coco import coco_image_path
    for sample in samples:
        path = coco_image_path(image_dir, sample["image"]["subset"],
                               sample["image"]["image_id"])
        with Image.open(path) as im:
            sample["image"]["W"], sample["image"]["H"] = im.size
    return samples


def predict_dataset(engine, dataset, task: str, batch_size: int,
                    num_eval_batches: Optional[int] = None,
                    beam_size: Optional[int] = None,
                    num_workers: int = 0, loader: str = "threads"):
    """Run batched inference over a dataset -> (predictions, boxes).

    `predictions[sample_id] = {"answer": str}` (beam search adds `answers`
    and `answer_probs`); `boxes[str(sample_id)] = {"boxes": (Q, 4),
    "relevance": (Q,)}`, the mapping the evaluators read. Only the first
    n_real rows of a padded batch are kept. `beam_size`: None/1 -> greedy
    (reference compute_predictions); K>1 -> batched beam search, keeping the
    top beam as the answer (with the reference's beam tail quirk).
    `num_workers`/`loader`: pooled image loading with batch lookahead
    (eval.num_workers / eval.loader; see iter_padded_batches).
    """
    id_field = TASK_TO_ID_FIELD[task]
    vocab_mask = None
    if task == "CocoClassification":
        vocab_mask = coco_vocab_mask(engine.vocab, use_syns=False)

    predictions, boxes = {}, {}
    for bi, (items, n_real) in enumerate(
            iter_padded_batches(dataset, batch_size,
                                num_workers=num_workers, loader=loader)):
        if num_eval_batches is not None and bi >= num_eval_batches:
            break
        images = np.stack([it["image"] for it in items])
        queries = [it["query"] for it in items]
        if beam_size and beam_size > 1:
            # reference_quirks: offline eval artifacts stay string-identical
            # to the reference's beam outputs (incl. its tail bug)
            bouts = engine.predict_beam(images, queries, beam_size,
                                        vocab_mask, reference_quirks=True)
            outs = [{"answer": b["answers"][0],
                     "answer_probs": b["answer_probs"],
                     "all_answers": b["answers"],
                     "boxes": b["boxes"], "relevance": b["relevance"]}
                    for b in bouts]
        else:
            outs = engine.predict(images, queries, vocab_mask)
        for it, out in zip(items[:n_real], outs[:n_real]):
            sample_id = it["sample"][id_field]
            if str(sample_id) in boxes:
                raise ValueError(f"{task}: sample id {sample_id} "
                                 f"({id_field}) occurs twice")
            predictions[sample_id] = {"answer": out["answer"]}
            if "all_answers" in out:
                predictions[sample_id]["answers"] = out["all_answers"]
                predictions[sample_id]["answer_probs"] = out["answer_probs"]
            boxes[str(sample_id)] = {"boxes": out["boxes"],
                                     "relevance": out["relevance"]}
    return predictions, boxes


def make_predictions(engine, dataset, task: str, batch_size: int,
                     eval_dir: str | Path, subset: str,
                     data_split: str = "gpv_split",
                     num_eval_batches: Optional[int] = None,
                     beam_size: Optional[int] = None,
                     num_workers: int = 0, loader: str = "threads"):
    """`predict_dataset`, then write `{task}_{subset}_boxes.h5py` (a group
    per sample id with `boxes` and `relevance`) and
    `{task}_{data_split}_{subset}_predictions.json`, as the JAX package
    does.

    Returns (predictions dict, boxes path, predictions path).
    """
    import h5py

    eval_dir = Path(eval_dir)
    eval_dir.mkdir(parents=True, exist_ok=True)
    predictions, boxes = predict_dataset(
        engine, dataset, task, batch_size, num_eval_batches, beam_size,
        num_workers, loader)
    boxes_path = eval_dir / f"{task}_{subset}_boxes.h5py"
    with h5py.File(boxes_path, "w") as boxes_h5:
        for key, entry in boxes.items():
            grp = boxes_h5.create_group(key)
            grp.create_dataset("boxes", data=entry["boxes"])
            grp.create_dataset("relevance", data=entry["relevance"])

    pred_path = eval_dir / f"{task}_{data_split}_{subset}_predictions.json"
    pred_path.write_text(json.dumps(predictions, default=str))
    return predictions, boxes_path, pred_path


def evaluate_predictions(task: str, samples, predictions, boxes,
                         eval_dir, subset: str, data_split: str = "gpv_split",
                         image_dir: Optional[str] = None):
    """Run the task evaluator per novelty split -> metrics dict (+json).

    `boxes` is the HDF5 file `make_predictions` wrote (a path), the
    in-memory mapping `predict_dataset` returns, or None."""
    if task in ("CocoDetection", "RefCocop") and image_dir is not None:
        samples = update_samples_with_image_size(image_dir, samples)

    preds_by_str = {str(k): v for k, v in predictions.items()}
    h5 = None
    if isinstance(boxes, (str, Path)):
        import h5py
        boxes = h5 = h5py.File(boxes, "r")
    evaluator_cls = EVALUATOR_CLASSES[task]
    novelties = (["everything", "seen_concepts", "held_out_concepts"]
                 if data_split == "gpv_split" else ["everything"])
    metrics = {}
    try:
        for novelty in novelties:
            ev = evaluator_cls(samples, preds_by_str, boxes)
            metrics[novelty] = ev.evaluate(novelty)
    finally:
        if h5 is not None:
            h5.close()

    out_path = (Path(eval_dir)
                / f"{task}_{data_split}_{subset}_metrics.json")
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(metrics, default=str, indent=1))
    return metrics


def compute_vqa_test_predictions(engine, dataset, batch_size,
                                 out_path, num_workers: int = 0,
                                 loader: str = "threads") -> list:
    """Eval-server format: [{'question_id', 'answer'}] (reference
    compute_vqa_test_predictions.py:29-67)."""
    results = []
    for items, n_real in iter_padded_batches(dataset, batch_size,
                                             num_workers=num_workers,
                                             loader=loader):
        images = np.stack([it["image"] for it in items])
        outs = engine.predict(images, [it["query"] for it in items])
        for it, out in zip(items[:n_real], outs[:n_real]):
            results.append({"question_id": it["sample"]["question_id"],
                            "answer": out["answer"]})
    Path(out_path).write_text(json.dumps(results))
    return results


def compute_cap_test_predictions(engine, dataset, batch_size,
                                 out_path, num_workers: int = 0,
                                 loader: str = "threads") -> list:
    """Eval-server format: [{'image_id', 'caption'}] (reference
    compute_cap_test_predictions.py:85-113)."""
    results = []
    for items, n_real in iter_padded_batches(dataset, batch_size,
                                             num_workers=num_workers,
                                             loader=loader):
        images = np.stack([it["image"] for it in items])
        outs = engine.predict(images, [it["query"] for it in items])
        for it, out in zip(items[:n_real], outs[:n_real]):
            results.append({"image_id": it["sample"]["image"]["image_id"],
                            "caption": out["answer"]})
    Path(out_path).write_text(json.dumps(results))
    return results
