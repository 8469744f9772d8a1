"""Batch assembly and the training loader, host side (counterpart of
`gpv_tpu/datasets/loader.py`).

Reference `detr_misc.collate_fn` and the `DataLoader(num_workers=...)` of
`exp/gpv/train_distr.py:213-222`. Images are already fixed-size (480x640),
so the collator emits one static batch dict of numpy arrays: tokenized
queries, encoded answers, padded target boxes with validity masks, task
ids and, with query dedup, the batch's unique query rows. Batches are
dropped to a fixed size (`drop_last`), so every step has one shape.

`DataLoader` shuffles with a seeded per-epoch order, takes a shard's rows
of each global batch (`parallel.mesh.shard_rows`: the shard's part of
each accumulation microbatch), and assembles batches on forked worker
processes,
one batch per task. A worker runs `dataset.get` and the collator only
(numpy, never torch or CUDA), so forking a process that has launched
kernels is safe; it stacks the batch's images into one shared-memory block
and sends only the block's name and the light fields back.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Dict, Iterator, List

import numpy as np

from ..losses.criterion import TASK_IDS
from ..parallel.mesh import shard_rows
from ..text.vocab import AnswerVocab
from ..text.wordpiece import WordPieceTokenizer


class Collator:
    DEDUP_BUCKET = 16  # unique-query rows are padded up to multiples of it

    def __init__(self, vocab: AnswerVocab, tokenizer: WordPieceTokenizer,
                 max_text_len: int = 20, max_query_len: int = 20,
                 max_target_boxes: int = 64,
                 answering_type: str = "generation",
                 dedup_queries: bool = False, dedup_bucket: int = None):
        self.vocab = vocab
        self.tokenizer = tokenizer
        self.max_text_len = max_text_len
        self.max_query_len = max_query_len
        self.max_target_boxes = max_target_boxes
        self.answering_type = answering_type
        # dedup_queries: always also emit the batch's unique query rows
        # (query_uniq_ids/valid (U,Tq), U a multiple of dedup_bucket capped
        # at B) and the gather-back indices query_gather (B,), so the train
        # step runs frozen BERT on U rows instead of B. Exact: BERT is
        # frozen and dropout-free.
        self.dedup_queries = dedup_queries
        self.dedup_bucket = (self.DEDUP_BUCKET if dedup_bucket is None
                             else dedup_bucket)

    def __call__(self, items: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
        B, M = len(items), self.max_target_boxes
        query_ids, query_valid = self.tokenizer.batch_encode(
            [it["query"] for it in items], self.max_query_len)
        answer_ids = self.vocab.encode_answers(
            [it.get("answer", "") for it in items], self.max_text_len,
            self.answering_type)
        # true length = position of the first pad (cls..stop inclusive)
        lens = (answer_ids != self.vocab.pad_id).sum(axis=1).astype(np.int32)

        boxes = np.zeros((B, M, 4), np.float32)
        box_valid = np.zeros((B, M), bool)
        has_boxes = np.zeros((B,), bool)
        for i, it in enumerate(items):
            if "boxes" in it:
                b = np.asarray(it["boxes"], np.float32).reshape(-1, 4)[:M]
                boxes[i, :len(b)] = b
                box_valid[i, :len(b)] = True
                has_boxes[i] = True

        batch = {
            "query_ids": query_ids,
            "query_valid": query_valid,
            "answer_ids": answer_ids,
            "answer_lens": lens,
            "task_id": np.asarray(
                [TASK_IDS.get(it["task"], 0) for it in items], np.int32),
            "has_answer": np.asarray(["answer" in it for it in items], bool),
            "boxes": boxes,
            "box_labels": np.zeros((B, M), np.int32),
            "box_valid": box_valid,
            "has_boxes": has_boxes,
        }
        if self.dedup_queries:
            batch.update(self.dedup_emission(query_ids, query_valid,
                                             self.dedup_bucket))
        if "image" in items[0]:
            batch["image"] = np.stack([it["image"] for it in items])
        return batch

    @classmethod
    def dedup_emission(cls, query_ids: np.ndarray, query_valid: np.ndarray,
                       bucket: int = None) -> Dict[str, np.ndarray]:
        """The dedup fields of a batch of tokenized queries: the unique rows
        padded (with the first unique row) up to a `bucket` multiple capped
        at B, and the gather-back indices."""
        bucket = cls.DEDUP_BUCKET if bucket is None else bucket
        B = len(query_ids)
        uniq, first, inverse = np.unique(
            query_ids, axis=0, return_index=True, return_inverse=True)
        U = min(B, max(bucket, -(-len(uniq) // bucket) * bucket))
        pad = U - len(uniq)
        uniq_ids = np.concatenate(
            [uniq, np.broadcast_to(uniq[:1], (pad, uniq.shape[1]))])
        uniq_valid = np.concatenate(
            [query_valid[first],
             np.broadcast_to(query_valid[first[:1]],
                             (pad, query_valid.shape[1]))])
        return {
            "query_uniq_ids": np.ascontiguousarray(uniq_ids),
            "query_uniq_valid": np.ascontiguousarray(uniq_valid),
            "query_gather": inverse.astype(np.int32).reshape(B),
        }


# ---- worker side: one forked process per worker, one batch per task ----

_WORKER_LOADER = None  # the DataLoader, set in each forked worker


def _worker_init(loader):
    global _WORKER_LOADER
    _WORKER_LOADER = loader


def to_shared_block(array: np.ndarray):
    """Copy `array` into a new shared-memory block and return its
    (name, shape, dtype). Ownership passes to the process that takes it
    with `take_shared_block`: this process's resource tracker forgets the
    block, else it would unlink it again at exit."""
    from multiprocessing import resource_tracker, shared_memory
    shm = shared_memory.SharedMemory(create=True, size=array.nbytes)
    np.ndarray(array.shape, array.dtype, buffer=shm.buf)[:] = array
    resource_tracker.unregister(shm._name, "shared_memory")
    shm.close()
    return shm.name, array.shape, str(array.dtype)


def take_shared_block(meta) -> np.ndarray:
    """Copy a `to_shared_block` block into an owning array and unlink it.
    The copy matters: reading a view of an unlinked block crashes."""
    from multiprocessing import shared_memory
    name, shape, dtype = meta
    shm = shared_memory.SharedMemory(name=name)
    try:
        return np.array(np.ndarray(shape, np.dtype(dtype), buffer=shm.buf))
    finally:
        shm.close()
        shm.unlink()


def _worker_batch(bi: int, idxs: np.ndarray, epoch: int):
    """Assemble batch `bi` in a worker: (its image's shared block or
    None, the batch without its image)."""
    batch = _WORKER_LOADER.load_batch(bi, idxs, epoch)
    image = batch.pop("image", None)
    return (None if image is None else to_shared_block(image)), batch


class DataLoader:
    """Shuffling, fixed-batch iterator with forked worker processes."""

    def __init__(self, dataset, collator: Collator, batch_size: int,
                 shuffle: bool = True, drop_last: bool = True,
                 num_workers: int = 8, seed: int = 0, prefetch: int = 4,
                 num_shards: int = 1, shard_id: int = 0,
                 grad_accum: int = 1):
        """`batch_size` is the global batch; with num_shards > 1 every
        shard iterates the same seeded global order and loads only its
        `batch_size // num_shards` rows of each batch: of each of the
        `grad_accum` microbatches the step splits the global batch into,
        the shard's contiguous part (`parallel.mesh.shard_rows`; with
        grad_accum 1 one contiguous block). num_workers <= 1 assembles
        batches in this process."""
        self.rows = shard_rows(batch_size, max(1, num_shards), shard_id,
                               grad_accum)
        if num_shards > 1 and not drop_last:
            raise ValueError("num_shards > 1 requires drop_last=True")
        self.dataset = dataset
        self.collator = collator
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.prefetch = max(1, prefetch)
        self.num_shards = max(1, num_shards)
        self.shard_id = shard_id
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _batches(self) -> List[np.ndarray]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(len(self))]
        if self.num_shards > 1:
            batches = [b[self.rows] for b in batches]
        return batches

    def load_batch(self, bi: int, idxs: np.ndarray,
                   epoch: int) -> Dict[str, np.ndarray]:
        """Batch `bi` of `epoch`: each item draws from a RandomState keyed
        by its row's position in the global batch, so a batch is the same
        whichever process or shard assembles it."""
        base = (self.seed * 1000003 + epoch * 9973 + bi * 131071) % (2 ** 31)
        rows = self.rows if self.num_shards > 1 else range(len(idxs))
        items = []
        for row, i in zip(rows, idxs):
            rng = np.random.RandomState((base + int(row)) % (2 ** 31))
            items.append(self.dataset.get(int(i), rng))
        return self.collator(items)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches, epoch = self._batches(), self.epoch
        if self.num_workers <= 1:
            for bi, idxs in enumerate(batches):
                yield self.load_batch(bi, idxs, epoch)
            return
        yield from self._iter_workers(batches, epoch)

    def _iter_workers(self, batches, epoch):
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        ctx = mp.get_context("fork")
        pending: deque = deque()
        with ProcessPoolExecutor(self.num_workers, mp_context=ctx,
                                 initializer=_worker_init,
                                 initargs=(self,)) as pool:
            try:
                # at most workers + prefetch batches in flight, so host
                # memory holds a bounded number of collated batches
                window = self.num_workers + self.prefetch
                nxt = 0
                while nxt < len(batches) or pending:
                    while nxt < len(batches) and len(pending) < window:
                        pending.append(pool.submit(_worker_batch, nxt,
                                                   batches[nxt], epoch))
                        nxt += 1
                    meta, batch = pending.popleft().result()
                    if meta is not None:
                        batch["image"] = take_shared_block(meta)
                    yield batch
            finally:
                # a consumer that stops early leaves blocks the workers
                # made: collect and unlink them
                for f in pending:
                    f.cancel()
                for f in pending:
                    if f.cancelled():
                        continue
                    try:
                        meta, _ = f.result()
                    except Exception:  # the batch failed: nothing to free
                        continue
                    if meta is not None:
                        take_shared_block(meta)
