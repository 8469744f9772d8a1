"""Batched greedy text decoding with a KV cache (counterpart of
`gpv_tpu/decode/greedy.py`).

Reference greedy loop (`exp/gpv/models/gpv.py:178-196`): start from
`__cls__`, take the top-1 each step, optional additive vocab mask, for
`max_text_len - 1` steps. The reference re-runs the decoder on the whole
prefix every step; with causal masking that equals one KV-cached token per
step, which is what runs here. The loop is a host loop over CUDA launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models.gpv import GPV


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
    mem_state = model.precompute_text_memory(memory)
    caches = model.init_text_cache(B, dev)
    tok = torch.full((B,), cls_id, dtype=torch.long, device=dev)
    tokens = torch.full((B, T1), cls_id if stop_id is None else stop_id,
                        dtype=torch.int32, device=dev)
    logits_buf = torch.zeros(B, T1, model.vocab_size, device=dev)
    stopped = torch.zeros(B, dtype=torch.bool, device=dev)
    steps = 0
    for t in range(T1):
        steps += 1
        logits = model.text_step(tok, mem_state, mem_valid, caches, t)
        if vocab_mask is not None:
            logits = logits + vocab_mask
        tok = logits.argmax(-1)
        tokens[:, t] = tok
        logits_buf[:, t] = logits
        if stop_id is not None:
            stopped |= tok == stop_id
            if bool(stopped.all()):
                break
    return tokens, logits_buf, steps
