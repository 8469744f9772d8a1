"""Batched greedy text decoding with a KV cache (counterpart of
`gpv_tpu/decode/greedy.py`).

Reference greedy loop (`exp/gpv/models/gpv.py:178-196`): start from
`__cls__`, take the top-1 each step, optional additive vocab mask, for
`max_text_len - 1` steps. The reference re-runs the decoder on the whole
prefix every step; with causal masking that equals one KV-cached token per
step, which is what runs here. Its spans (`utils.profiling`) are
`decode.prepare` (the memory's keys and values, the cache), `decode.step`
(one iteration), inside it `decode.stop_wait` (the host's per-step wait on
the card) and, in the first step of a graphed call, `decode.capture`.

A step is about fifty small launches, and issuing them from Python costs
the host far more than they cost the card. So on a CUDA device, with the
text decoder not sharded (`_graphable`), a call captures one step as a
CUDA graph in its first step and replays it for every step: the step
reads its position `t` from a 0-d tensor on the device and ends by
writing the next token, the stop flags and `t + 1` there, so a replay
needs nothing from the host. Every other call (the CPU, a tensor-parallel
decoder, whose row-parallel FFN issues collectives) runs the same steps
as a host loop. Both give the same tokens, logits and step count.

A graph is captured per call and never replayed after it: it reads the
call's caches and buffers, which a graph kept per batch shape would hold
alive under the next call's encode (the memory's cross-attention K/V
alone is about 22 MB at B=20). What is kept is the last graph captured on
each stream, never replayed again, so that the next capture there takes
its memory pool: none of the pool's blocks is allocated between calls,
while a pool dropped with its graph stays reserved until the allocator
runs short or its cache is emptied, and each call would reserve anew.

The capture runs on the caller's current stream, or forks from the
default stream onto one of the calling thread's own (`utils.cuda_graph`),
so the caller must not share that stream with another thread during the
call; `GPVEngine` gives each calling thread streams of its own.

Counters, in the style of the kernels' `launches`:
`greedy_decode.captures`, `greedy_decode.replays` and
`greedy_decode.eager_steps`; `replays / (replays + eager_steps)` is the
share of decode steps that ran graphed.
"""
from __future__ import annotations

import threading
from typing import Optional

import torch

from ..models.gpv import GPV
from ..ops.attention import add_counts
from ..utils.cuda_graph import capture, capture_stream
from ..utils.profiling import span

_stats_lock = threading.Lock()
_pool_of: dict = {}        # capture stream -> its last graph (its pool)


def init_cache(model: GPV, batch: int):
    """The text decoder's empty KV cache for `batch` rows, on the model's
    device and in its dtype (`gpv_tpu.decode.greedy.init_cache`): one
    (K, V) pair of (batch, max_text_len, heads, head_dim) zeros a layer."""
    return model.init_text_cache(batch, next(model.parameters()).device)


def _graphable(model: GPV, device: torch.device) -> bool:
    """Whether a decode on `device` replays a captured step: on a CUDA
    device, with no layer of the text decoder sharded."""
    return device.type == "cuda" and all(
        layer.self_attn.tp is None and layer.multihead_attn.tp is None
        and layer.ffn_tp is None for layer in model.text_decoder.layers)


@torch.inference_mode()
def greedy_decode(model: GPV, memory: torch.Tensor,
                  mem_valid: Optional[torch.Tensor], cls_id: int,
                  vocab_mask: Optional[torch.Tensor] = None,
                  stop_id: Optional[int] = None):
    """Decode answers for a batch.

    Args:
      memory: (B, Tm, D) fused decode memory from `GPV.encode`.
      vocab_mask: optional (V,) additive mask (0 allowed / -10000 banned).
      stop_id: when given, the loop exits once every sequence has emitted
        `stop_id` (one host check per step); positions never decoded hold
        `stop_id` and zero logits, as in the JAX package.

    Returns:
      token_ids: (B, T-1) int32 ids for positions 1..T-1.
      logits: (B, T-1, V) fp32 logits that produced them (mask applied).
      steps: the number of decode steps run.
    """
    B, dev = memory.shape[0], memory.device
    T1 = model.max_text_len - 1
    with span("decode.prepare"):
        mem_state = model.precompute_text_memory(memory)
        caches = model.init_text_cache(B, dev)
        tok = torch.full((B,), cls_id, dtype=torch.long, device=dev)
        tokens = torch.full((B, T1), cls_id if stop_id is None else stop_id,
                            dtype=torch.int32, device=dev)
        logits_buf = torch.zeros(B, T1, model.vocab_size, device=dev)
        stopped = torch.zeros(B, dtype=torch.bool, device=dev)
    state = (model, mem_state, mem_valid, caches, tok, tokens, logits_buf,
             stopped, vocab_mask, stop_id)
    if _graphable(model, dev):
        steps = _device_loop(*state, capture=_capture)
    else:
        steps = _host_loop(*state)
    return tokens, logits_buf, steps


greedy_decode.captures = 0
greedy_decode.replays = 0
greedy_decode.eager_steps = 0


def _host_loop(model, mem_state, mem_valid, caches, tok, tokens, logits_buf,
               stopped, vocab_mask, stop_id) -> int:
    """The steps as launches issued from the host, `t` a Python int."""
    steps = 0
    for t in range(tokens.shape[1]):
        with span("decode.step"):
            steps += 1
            logits = model.text_step(tok, mem_state, mem_valid, caches, t)
            if vocab_mask is not None:
                logits = logits + vocab_mask
            tok = logits.argmax(-1)
            tokens[:, t] = tok
            logits_buf[:, t] = logits
            if stop_id is not None:
                stopped |= tok == stop_id
                with span("decode.stop_wait"):
                    done = bool(stopped.all())
                if done:
                    break
    with _stats_lock:
        greedy_decode.eager_steps += steps
    return steps


def _device_loop(model, mem_state, mem_valid, caches, tok, tokens,
                 logits_buf, stopped, vocab_mask, stop_id, capture) -> int:
    """The steps as one step whose state lives on the device: `capture(
    step, device)` returns what runs it (on the card, a graph's replay)."""
    dev = tok.device
    t = torch.zeros((), dtype=torch.long, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)

    def step():
        logits = model.text_step(tok, mem_state, mem_valid, caches, t)
        if vocab_mask is not None:
            logits = logits + vocab_mask
        nxt = logits.argmax(-1)
        at = t.view(1)
        tokens.index_copy_(1, at, nxt[:, None].to(tokens.dtype))
        logits_buf.index_copy_(1, at, logits[:, None])
        tok.copy_(nxt)
        if stop_id is not None:
            stopped.logical_or_(nxt == stop_id)
            torch.all(stopped, out=done)
        t.add_(1)

    steps, run = 0, None
    for _ in range(tokens.shape[1]):
        with span("decode.step"):
            steps += 1
            if run is None:
                with span("decode.capture"):
                    run = capture(step, dev)
            run()
            if stop_id is not None:
                with span("decode.stop_wait"):
                    stop = bool(done)
                if stop:
                    break
    return steps


def _capture(step, device: torch.device):
    """`step` captured as a CUDA graph (`utils.cuda_graph.capture`) into
    the pool of the last graph captured on its stream; returns its replay,
    which also counts the K1 launches the graph runs."""
    cap = capture_stream(device)
    held = _pool_of.get(cap.cuda_stream)
    graph, tally, _ = capture(step, device,
                              None if held is None else held.pool())
    _pool_of[cap.cuda_stream] = graph
    with _stats_lock:
        greedy_decode.captures += 1

    def replay():
        graph.replay()
        add_counts(tally)
        with _stats_lock:
            greedy_decode.replays += 1
    return replay
