"""Batched greedy text decoding with a KV cache (counterpart of
`gpv_tpu/decode/greedy.py`).

Reference greedy loop (`exp/gpv/models/gpv.py:178-196`): start from
`__cls__`, take the top-1 each step, optional additive vocab mask, for
`max_text_len - 1` steps. The reference re-runs the decoder on the whole
prefix every step; with causal masking that equals one KV-cached token per
step, which is what runs here. Its spans (`utils.profiling`) are
`decode.prepare` (the memory's keys and values, the cache, the logits),
`decode.step` (one iteration), inside it `decode.stop_wait` (the host's
per-step wait on the card) and, in the first step of a graphed call,
`decode.capture`.

`greedy_loop` is the one loop, over the model's step (`greedy_decode`)
or a serving bundle's step program (`export.ExportedEngine`). Its state
lives on the device: the step reads its position `t` from a 0-d tensor
and ends by writing the next token, the token and logits buffers, the
stop flags and `t + 1` there, so a step needs nothing from the host. A
step is about fifty small launches, and issuing them from Python costs
the host far more than they cost the card. So on a CUDA device, with the
text decoder not sharded (`_graphable`), `greedy_decode` captures the
step as a CUDA graph in its first step (on the caller's stream,
`ops.cuda_graph`) and replays it for every step; every other call (the
CPU, a tensor-parallel decoder, whose row-parallel FFN issues
collectives, a bundle) runs the same step eagerly.

A graph is captured per call and never replayed after it: it reads the
call's caches and buffers, which a graph kept per batch shape would hold
alive under the next call's encode (the memory's cross-attention K/V
alone is about 22 MB at B=20). The pool rule: the last graph captured on
each stream is kept, never replayed again, so that the next capture there
takes its memory pool; none of the pool's blocks is allocated between
calls, while a pool dropped with its graph stays reserved until the
allocator runs short or its cache is emptied, and each call would reserve
anew.

Counters, in the style of the kernels' `launches` (`ops._cuda.count`):
`greedy_decode.captures`, `greedy_decode.replays` and
`greedy_decode.eager_steps`; `replays / (replays + eager_steps)` is the
share of `greedy_decode`'s steps that ran graphed.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Optional

import torch

from ..ops import _cuda
from ..ops.cuda_graph import capture, capture_stream
from ..utils.profiling import span

if TYPE_CHECKING:
    from ..models.gpv import GPV

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
    with span("decode.prepare"):
        mem_state = model.precompute_text_memory(memory)
        caches = model.init_text_cache(B, dev)
        logits = torch.zeros(B, model.max_text_len - 1, model.vocab_size,
                             device=dev)
    graphed = _graphable(model, dev)
    tokens, steps = greedy_loop(
        lambda tok, t: model.text_step(tok, mem_state, mem_valid, caches, t),
        logits, cls_id, vocab_mask, stop_id, _capture if graphed else None)
    if not graphed:
        _cuda.count(greedy_decode, "eager_steps", steps)
    return tokens, logits, steps


greedy_decode.captures = 0
greedy_decode.replays = 0
greedy_decode.eager_steps = 0


def greedy_loop(step_logits, logits: torch.Tensor, cls_id: int,
                vocab_mask: Optional[torch.Tensor] = None,
                stop_id: Optional[int] = None, capture_step=None):
    """The greedy loop (module docstring) over `step_logits(tok, t)`, which
    returns the (B, V) fp32 logits of the (B,) int64 tokens `tok` at the
    0-d int64 position `t`, both on the device. Writes each step's logits
    (mask applied) into `logits` (B, T-1, V), and returns (token ids (B,
    T-1) int32, the steps run), `stop_id` as in `greedy_decode`.
    `capture_step(step, device)`, when given, returns what runs the step
    (on the card, a graph's replay); without it the step runs eagerly."""
    B, T1, dev = logits.shape[0], logits.shape[1], logits.device
    tok = torch.full((B,), cls_id, dtype=torch.long, device=dev)
    tokens = torch.full((B, T1), cls_id if stop_id is None else stop_id,
                        dtype=torch.int32, device=dev)
    stopped = torch.zeros(B, dtype=torch.bool, device=dev)
    t = torch.zeros((), dtype=torch.long, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)

    def step():
        out = step_logits(tok, t)
        if vocab_mask is not None:
            out = out + vocab_mask
        nxt = out.argmax(-1)
        at = t.view(1)
        tokens.index_copy_(1, at, nxt[:, None].to(tokens.dtype))
        logits.index_copy_(1, at, out[:, None])
        tok.copy_(nxt)
        if stop_id is not None:
            stopped.logical_or_(nxt == stop_id)
            torch.all(stopped, out=done)
        t.add_(1)

    steps, run = 0, step if capture_step is None else None
    for _ in range(T1):
        with span("decode.step"):
            steps += 1
            if run is None:
                with span("decode.capture"):
                    run = capture_step(step, dev)
            run()
            if stop_id is not None:
                with span("decode.stop_wait"):
                    stop = bool(done)
                if stop:
                    break
    return tokens, steps


def _capture(step, device: torch.device):
    """`step` captured as a CUDA graph (`ops.cuda_graph.capture`) into the
    pool of the last graph captured on its stream; returns its replay,
    which also counts the replays."""
    cap = capture_stream(device)
    held = _pool_of.get(cap.cuda_stream)
    graph = capture(step, device,
                    None if held is None else held.graph.pool())
    _pool_of[cap.cuda_stream] = graph
    _cuda.count(greedy_decode, "captures")

    def replay():
        graph.replay()
        _cuda.count(greedy_decode, "replays")
    return replay
