"""CUDA graphs captured from the calling thread, and the calling thread's
own streams: what the greedy decode's step (`decode.greedy`), the model
encode (`models.encode_graph`) and `GPVEngine`'s shards share.

A capture runs on the caller's current stream when that is not the
default stream (which cannot be captured), so the caller must not share
that stream with another thread during the capture; on the default
stream it forks onto a stream of the calling thread's own (`own_stream`)
and joins back.

`own_stream` is the one registry of streams, one per calling thread,
device and slot: each stream holds a cuBLAS workspace of its own (33 MiB
on the H100).
"""
from __future__ import annotations

import threading

import torch

from . import _cuda

_own = threading.local()   # .streams: {(device index, slot): stream}


def own_stream(device: torch.device, slot: int = 0) -> torch.cuda.Stream:
    """The calling thread's stream `slot` on `device`, made at its first
    use."""
    streams = getattr(_own, "streams", None)
    if streams is None:
        streams = _own.streams = {}
    key = (torch.cuda.current_device() if device.index is None
           else device.index, slot)
    stream = streams.get(key)
    if stream is None:
        stream = streams[key] = torch.cuda.Stream(device)
    return stream


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream a capture from the calling thread runs on (module
    docstring)."""
    cur = torch.cuda.current_stream(device)
    return cur if cur != torch.cuda.default_stream(device) \
        else own_stream(device)


class Graph:
    """A captured CUDA graph (`graph`), what the captured function returned
    (`outputs`: tensors each replay reads or writes in place) and the
    hand-written kernels' launches the capture counted (`tally`)."""

    def __init__(self, graph: torch.cuda.CUDAGraph, outputs, tally: dict):
        self.graph, self.outputs, self.tally = graph, outputs, tally

    def replay(self) -> None:
        """Replay the graph and count the kernels it ran."""
        self.graph.replay()
        _cuda.add_counts(self.tally)


def capture(fn, device: torch.device, pool=None) -> Graph:
    """`fn()` captured as a CUDA graph into the memory pool `pool` (None: a
    pool of the graph's own). The hand-written kernels' launches during
    the capture go to the graph's tally (`ops._cuda.count_into`). Captured
    with `capture_begin`/`capture_end` and not the `torch.cuda.graph`
    context, which synchronises the card, collects garbage and empties the
    allocator's cache on each entry; in "thread_local" mode, so another
    thread keeps launching meanwhile."""
    _cuda.load_kernels()
    cur = torch.cuda.current_stream(device)
    cap = capture_stream(device)
    if cap != cur:
        cap.wait_stream(cur)
    graph, tally = torch.cuda.CUDAGraph(), {}
    with torch.cuda.stream(cap), _cuda.count_into(tally):
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            out = fn()
        finally:
            graph.capture_end()
    if cap != cur:
        cur.wait_stream(cap)
    return Graph(graph, out, tally)
