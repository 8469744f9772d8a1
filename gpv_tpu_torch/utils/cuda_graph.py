"""Capturing a CUDA graph from the calling thread: what the greedy decode's
step (`decode.greedy`) and the model encode (`models.encode_graph`)
share.

A capture runs on the caller's current stream when that is not the
default stream (which cannot be captured), so the caller must not share
that stream with another thread during the capture; on the default
stream it forks onto a stream of the calling thread's own
(`own_stream`), whose cuBLAS workspace (one per stream and thread, 33 MiB
on the H100) it then keeps, and joins back.
"""
from __future__ import annotations

import threading

import torch

from ..ops.attention import count_into, load_kernels

_own = threading.local()   # .streams: {device index: the thread's stream}


def own_stream(device: torch.device) -> torch.cuda.Stream:
    """The calling thread's stream on `device`, made at its first use."""
    streams = getattr(_own, "streams", None)
    if streams is None:
        streams = _own.streams = {}
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    stream = streams.get(index)
    if stream is None:
        stream = streams[index] = torch.cuda.Stream(device)
    return stream


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream a capture from the calling thread runs on (module
    docstring)."""
    cur = torch.cuda.current_stream(device)
    return cur if cur != torch.cuda.default_stream(device) \
        else own_stream(device)


def capture(fn, device: torch.device, pool=None):
    """`fn()` captured as a CUDA graph into the memory pool `pool` (None: a
    pool of the graph's own). Returns (graph, tally, what `fn` returned):
    `tally` holds the hand-written kernels' launches the capture counted
    (`ops.attention.count_into`); each replay adds it (`add_counts`), so
    the kernels' counters hold the kernels that ran. Captured with
    `capture_begin`/`capture_end` and not the `torch.cuda.graph` context,
    which synchronises the card, collects garbage and empties the
    allocator's cache on each entry; in "thread_local" mode, so another
    thread keeps launching meanwhile."""
    load_kernels()
    cur = torch.cuda.current_stream(device)
    cap = capture_stream(device)
    if cap != cur:
        cap.wait_stream(cur)
    graph, tally = torch.cuda.CUDAGraph(), {}
    with torch.cuda.stream(cap), count_into(tally):
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            out = fn()
        finally:
            graph.capture_end()
    if cap != cur:
        cur.wait_stream(cap)
    return graph, tally, out
