"""`GPV.encode` replayed as a CUDA graph kept per input key.

Encode is hundreds of short launches (ResNet, DETR's layers, BERT's,
co-attention), and issuing them from Python costs the host more than
they cost the card. So a call that can be graphed (`graphable`: inputs on
a CUDA device, no gradient recorded, no `query_enc`, the model not
sharded, the caller not traced, no forward hook or pre-hook on any of
the model's modules nor a global one) looks up its key (`key`: the
inputs' shapes, strides, dtypes and devices, which masks are None,
`train`, and the inference, autocast and TF32 modes, which choose what
the body makes and runs):

- a key seen for the first time runs eager: it warms cuDNN's plans,
  cuBLAS's handles and the kernels' builds, and a shape seen once never
  pays for a capture;
- the second call with a key captures the body (`GPV._encode`) on static
  input buffers (`ops.cuda_graph.capture`, the launches of the
  hand-written kernels counted into the graph's tally) and replays it;
- every later call copies its inputs into the buffers, replays, and
  returns fresh copies of the outputs, so a result a caller keeps is
  never overwritten by the next call.

Each model keeps the graphs of at most `MAX_GRAPHS` keys a device (and
remembers as many keys seen once), the least recently used dropped
first. The graphs read the weights where they were at the capture, so
`GPV._apply` (`.to()`, `.cuda()`, `.half()`, ...) drops them (`drop`); a
model whose modules or parameters are replaced otherwise after a
capture has to be dropped by its owner.

The pool rule: the encode graphs of one device share one private memory
pool, so the serving buckets do not each reserve their own activations:
a capture takes the pool of a graph of the device still alive (a pool
whose graphs are all gone may not be captured into again), else a new
one. Graphs of one pool may hand each other's blocks on, so their
replays never overlap: a replay holds its device's lock over copy-in,
replay and copy-out, and its stream waits on the event the previous
replay recorded after its copy-out. Replays may come from any thread and
stream (the server warms up on its main thread and its workers replay on
their own streams).

Counters, as in `decode.greedy` (`ops._cuda.count`):
`GPV.encode.captures`, `GPV.encode.replays` and `GPV.encode.eager_calls`;
`replays / (replays + eager_calls)` is the share of encode calls that ran
graphed. Spans: `encode.capture` (the capture, in the call that
captures) and `encode.replay` (copy-in, replay, copy-out).
"""
from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import Optional

import torch
from torch import nn

from ..ops import _cuda
from ..ops.cuda_graph import capture
from ..utils.profiling import span

MAX_GRAPHS = 4   # keys a model keeps graphs of on a device

_lock = threading.Lock()
_devices: dict = {}                    # CUDA device index -> _Device
_models = weakref.WeakKeyDictionary()  # model -> _Model


class _Device:
    """What the encode graphs of one device share (module docstring)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.done = torch.cuda.Event()   # after the last replay's copy-out
        self.live = weakref.WeakSet()    # its graphs: their pool


class _Model:
    """A model's modules' forward hook and pre-hook tables (for the hook
    check: `register_forward_hook` and a handle's `remove` change them in
    place) and its graphs and keys seen once, by device."""

    def __init__(self, model: nn.Module):
        self.hooks = tuple(table for m in model.modules()
                           for table in (m._forward_hooks,
                                         m._forward_pre_hooks))
        self.graphs: dict = {}   # _Device -> OrderedDict key -> Graph
        self.seen: dict = {}     # _Device -> OrderedDict key -> None


def _entry(model: nn.Module) -> _Model:
    entry = _models.get(model)
    if entry is None:
        with _lock:
            entry = _models.get(model)
            if entry is None:
                entry = _models[model] = _Model(model)
    return entry


def _device(device: torch.device) -> _Device:
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    dev = _devices.get(index)
    if dev is None:
        with _lock:
            dev = _devices.get(index)
            if dev is None:
                dev = _devices[index] = _Device()
    return dev


def _hooked(model: nn.Module) -> bool:
    """Whether a forward hook or pre-hook would run in the model's forward
    (on any of its modules, or a global one): a replay would skip it."""
    glob = nn.modules.module
    return bool(glob._global_forward_hooks or glob._global_forward_pre_hooks
                or any(_entry(model).hooks))


def graphable(model, device: torch.device, query_enc, traced: bool) -> bool:
    """Whether an encode call replays a graph (module docstring): inputs on
    `device`, `query_enc` as given, `traced` whether torch.export or
    torch.compile traces the call (`ops._cuda.traced`)."""
    return (device.type == "cuda" and not traced and query_enc is None
            and not torch.is_grad_enabled() and model.tp is None
            and not _hooked(model))


def key(inputs: tuple, train: bool) -> tuple:
    """The key of a call (module docstring) with `inputs` (images,
    query_ids, image_valid, query_valid)."""
    return (bool(train), torch.is_inference_mode_enabled(),
            torch.is_autocast_enabled("cuda"),
            torch.get_autocast_dtype("cuda"),
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            *(None if t is None else (t.shape, t.stride(), t.dtype, t.device)
              for t in inputs))


def encode(model, counters, inputs: tuple, train: bool) -> Optional[tuple]:
    """A graphable call's encode (module docstring): the body's outputs
    from a replay, or None for a key seen for the first time, which the
    caller runs eager. `counters` holds `captures` and `replays`."""
    k = key(inputs, train)
    dev, entry = _device(inputs[0].device), _entry(model)
    graphs = entry.graphs.setdefault(dev, OrderedDict())
    seen = entry.seen.setdefault(dev, OrderedDict())
    with dev.lock:
        graph = graphs.get(k)
        if graph is not None:
            graphs.move_to_end(k)
        elif k not in seen:
            seen[k] = None
            if len(seen) > MAX_GRAPHS:
                seen.popitem(last=False)
            return None
        else:
            del seen[k]
            with span("encode.capture"):
                graph = _capture(model, inputs, train, dev)
            _cuda.count(counters, "captures")
            graphs[k] = graph
            if len(graphs) > MAX_GRAPHS:
                dev.done.synchronize()   # no replay of it is in flight
                graphs.popitem(last=False)
        with span("encode.replay"):
            out = _replay(graph, inputs, dev)
    _cuda.count(counters, "replays")
    return out


def _capture(model, inputs: tuple, train: bool, dev: _Device):
    """The body captured on static input buffers (None for a None mask);
    the graph's outputs are (the buffers, the body's outputs)."""
    static = tuple(None if t is None else torch.empty_like(t)
                   for t in inputs)
    alive = next(iter(dev.live), None)   # held: its pool stays in use
    graph = capture(lambda: (static, model._encode(*static, train)),
                    inputs[0].device,
                    None if alive is None else alive.graph.pool())
    dev.live.add(graph)
    return graph


def _replay(graph, inputs: tuple, dev: _Device) -> tuple:
    static, (memory, mem_valid, outputs) = graph.outputs
    stream = torch.cuda.current_stream(inputs[0].device)
    stream.wait_event(dev.done)
    for buf, t in zip(static, inputs):
        if buf is not None:
            buf.copy_(t)
    graph.replay()
    out = (memory.clone(), None if mem_valid is None else mem_valid.clone(),
           {name: t.clone() for name, t in outputs.items()})
    dev.done.record(stream)
    return out


def drop(model) -> None:
    """Drop the model's graphs and its keys seen once (module docstring),
    once no replay of them is in flight."""
    entry = _models.pop(model, None)
    if entry is None:
        return
    for dev, graphs in entry.graphs.items():
        with dev.lock:
            dev.done.synchronize()
            graphs.clear()
