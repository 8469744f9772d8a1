"""GPVServer: asynchronous batching inference server (counterpart of
`gpv_tpu/serve.py`).

Requests are queued, coalesced into batches of requests that share a vocab
mask and a beam size, padded by repetition to the smallest bucket that
fits, run on the engine by a pool of worker threads (two keep one batch's
host work going while another runs on the card) and resolved through
futures. The engine's CUDA work releases the interpreter lock, so the
workers overlap.

Spans (`utils.profiling`): `serve.queue` for each request, from its
submit to the start of the batch that runs it; then, in the worker,
`serve.coalesce` (from its first pop to the batch closed),
`serve.execute` (the engine call, whose own spans nest inside) and
`serve.resolve` (the futures). The workers' spans also carry their
thread CPU time.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Optional

import numpy as np

from .utils.profiling import record, span, thread_cpu


class GPVServer:
    def __init__(self, engine, batch_size: int = 20,
                 max_wait_ms: float = 5.0, num_workers: int = 2,
                 bucket_sizes=None, warmup=None):
        """bucket_sizes: optional ascending pad targets (e.g. (1, 8, 20)).
        A batch of n requests pads to the smallest bucket >= n instead of
        always to batch_size; the largest bucket is the batch size.
        warmup: optional (H, W): run one `predict` per bucket at that image
        size, without and with a vocab mask, before serving (cuDNN plans,
        the allocator's pools and the kernels' builds happen there, not in
        the first requests). Nothing is compiled per shape."""
        self.engine = engine
        if bucket_sizes:
            bucket_sizes = sorted(int(b) for b in bucket_sizes)
            batch_size = bucket_sizes[-1]
        self.buckets = tuple(bucket_sizes or (batch_size,))
        self.batch_size = batch_size
        self.max_wait_s = max_wait_ms / 1000.0
        if warmup:
            h, w = warmup
            vm = np.zeros((len(engine.vocab),), np.float32)
            for b in self.buckets:
                images = np.zeros((b, h, w, 3), np.uint8)
                engine.predict(images, ["warm up"] * b)
                engine.predict(images, ["warm up"] * b, vm)
        self._q: "queue.Queue" = queue.Queue()
        # requests deferred by a key mismatch, served before the queue at
        # the next collection so a minority key is never starved
        self._pending: list = []
        self._pending_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._submitted = 0
        self._completed = 0
        self._failed = 0
        self._deferred = 0
        self._batches = {b: 0 for b in self.buckets}
        self._occupied_rows = 0
        self._padded_rows = 0
        self._latencies: deque = deque(maxlen=1000)
        self._closed = threading.Event()
        self._closing = threading.Event()  # rejects submits while draining
        # submit/close serialisation and the busy-worker count:
        # close(drain=True) must not call the server idle while a worker
        # holds popped requests
        self._lifecycle_lock = threading.Lock()
        self._busy = 0
        self._workers = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(max(1, num_workers))]
        for w in self._workers:
            w.start()

    def submit(self, image_uint8: np.ndarray, query: str,
               vocab_mask: Optional[np.ndarray] = None,
               beam_size: Optional[int] = None) -> Future:
        """Enqueue one request; resolves to {answer, boxes, relevance}.

        beam_size K >= 1 (None: greedy) routes the request through
        `engine.predict_beam`; it resolves to {answers, answer_probs,
        boxes, relevance, answer} with `answer` the top beam. K = 1 is a
        1-beam search, so a beam request always gets `answers`. Requests
        share a batch only when their vocab mask and beam size match. An
        engine without `predict_beam` (an `ExportedEngine`) refuses a beam
        request here with ValueError."""
        fut: Future = Future()
        beam = None if beam_size is None else int(beam_size)
        if beam is not None and beam < 1:
            raise ValueError(f"beam_size must be >= 1, got {beam}")
        if beam is not None and not hasattr(self.engine, "predict_beam"):
            # refused at the door: inside a worker it would fail the whole
            # coalesced batch
            raise ValueError(
                "beam_size requested but this engine does not support beam "
                "search (no predict_beam; exported bundles serve greedy "
                "only)")
        with self._lifecycle_lock:
            if self._closed.is_set() or self._closing.is_set():
                raise RuntimeError("server closed")
            self._q.put((image_uint8, query, vocab_mask, beam, fut,
                         time.perf_counter_ns()))
        with self._stats_lock:
            self._submitted += 1
        return fut

    @staticmethod
    def _mask_key(mask) -> Optional[tuple]:
        """Requests share a batch only when their masks are byte-identical
        (the engine applies one mask to the whole batch)."""
        if mask is None:
            return None
        m = np.asarray(mask)
        return (m.shape, m.dtype.str, m.tobytes())

    @classmethod
    def _batch_key(cls, item) -> tuple:
        return (cls._mask_key(item[2]), item[3])

    def _collect(self):
        """Up to batch_size requests of one batch key; the oldest deferred
        request seeds the batch, so every request is served within one
        batch of being deferred."""
        with self._pending_lock:
            first = self._pending.pop(0) if self._pending else None
        if first is None:
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                return None
        # from here until _execute ends this worker holds requests that are
        # in neither _q nor _pending
        with self._lifecycle_lock:
            self._busy += 1
        with span("serve.coalesce"):
            return self._fill(first)

    def _fill(self, first) -> list:
        """`first` and the requests of its batch key that join it within
        the coalescing window, up to batch_size; requests of other keys
        are deferred."""
        items = [first]
        key = self._batch_key(first)
        deferred = []
        deadline = time.monotonic() + self.max_wait_s
        with self._pending_lock:  # deferred requests of this key join first
            keep = []
            for it in self._pending:
                if len(items) < self.batch_size and \
                        self._batch_key(it) == key:
                    items.append(it)
                else:
                    keep.append(it)
            self._pending[:] = keep
        while len(items) < self.batch_size:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                it = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            (items if self._batch_key(it) == key else deferred).append(it)
        if deferred:
            late = []
            with self._pending_lock:
                self._pending.extend(deferred)
                if self._closed.is_set():
                    # close() already cancelled the pending list; nothing
                    # will serve these
                    late = list(self._pending)
                    self._pending.clear()
            for it in late:
                it[4].cancel()
            with self._stats_lock:
                self._deferred += len(deferred)
        return items

    def _worker(self):
        thread_cpu()   # whether the workers wait off a core is the question
        while not self._closed.is_set():
            items = self._collect()
            if items:
                try:
                    self._execute(items)
                finally:
                    with self._lifecycle_lock:
                        self._busy -= 1

    def _execute(self, items):
        """Run one coalesced batch and resolve its futures."""
        start = time.perf_counter_ns()
        for it in items:
            record("serve.queue", it[5], start)
        n = len(items)
        images = [it[0] for it in items]
        queries = [it[1] for it in items]
        mask, beam = items[0][2], items[0][3]
        target = next((b for b in self.buckets if b >= n), self.batch_size)
        while len(images) < target:  # pad by repeating the last request
            images.append(images[-1])
            queries.append(queries[-1])
        try:
            with span("serve.execute"):
                if beam:
                    outs = self.engine.predict_beam(
                        np.stack(images), queries, beam_size=beam,
                        vocab_mask=mask)
                    for o in outs:
                        o["answer"] = o["answers"][0]
                else:
                    outs = self.engine.predict(np.stack(images), queries,
                                               mask)
            with span("serve.resolve"):
                done = time.perf_counter_ns()
                resolved = []
                for (_, _, _, _, fut, t0), out in zip(items, outs[:n]):
                    # a client may have cancelled a queued future: that
                    # must neither fail the batch nor count as completed
                    if fut.set_running_or_notify_cancel():
                        fut.set_result(out)
                        resolved.append((done - t0) * 1e-9)
                with self._stats_lock:
                    self._batches[target] = self._batches.get(target,
                                                              0) + 1
                    self._occupied_rows += n
                    self._padded_rows += target - n
                    self._completed += len(resolved)
                    self._latencies.extend(resolved)
        except Exception as e:  # the batch fails; the server keeps serving
            failed = 0
            for _, _, _, _, fut, _ in items:
                if not fut.done() and fut.set_running_or_notify_cancel():
                    fut.set_exception(e)
                    failed += 1
            with self._stats_lock:
                self._failed += failed

    def stats(self) -> dict:
        """Serving counters: occupancy = real rows / executed rows; latency
        percentiles (ms, submit -> result) over the last 1000 requests."""
        with self._stats_lock:
            lat = sorted(self._latencies)
            executed = self._occupied_rows + self._padded_rows
            out = {
                "submitted": self._submitted,
                "completed": self._completed,
                "failed": self._failed,
                "queued": self._q.qsize() + len(self._pending),
                "mask_deferrals": self._deferred,
                "batches_per_bucket": dict(self._batches),
                "batch_occupancy": (self._occupied_rows / executed
                                    if executed else None),
                "buckets": list(self.buckets),
            }
        if lat:
            def pct(p):
                return round(1000 * lat[min(len(lat) - 1,
                                            int(p * len(lat)))], 3)
            out["latency_ms"] = {"p50": pct(0.50), "p90": pct(0.90),
                                 "p99": pct(0.99), "n": len(lat)}
        else:
            out["latency_ms"] = None
        return out

    def close(self, drain: bool = True, timeout: float = 120.0):
        """Shut down without stranding clients: drain=True serves what is
        queued first; either way every request still unresolved after the
        workers stop has its future cancelled."""
        if self._closed.is_set():
            return
        with self._lifecycle_lock:
            self._closing.set()
        if drain:
            deadline = time.monotonic() + timeout
            stable = 0
            while time.monotonic() < deadline:
                with self._lifecycle_lock:
                    idle = self._busy == 0
                with self._pending_lock:
                    no_pending = not self._pending
                # idle must hold over 3 spaced looks: a worker between
                # q.get() and its busy increment is invisible for an instant
                if self._q.empty() and no_pending and idle:
                    stable += 1
                    if stable >= 3:
                        break
                else:
                    stable = 0
                time.sleep(0.01)
        self._closed.set()
        for w in self._workers:
            w.join(timeout=max(1.0, timeout / 4))
        with self._pending_lock:
            leftovers = list(self._pending)
            self._pending.clear()
        while True:
            try:
                leftovers.append(self._q.get_nowait())
            except queue.Empty:
                break
        for _, _, _, _, fut, _ in leftovers:
            fut.cancel()
