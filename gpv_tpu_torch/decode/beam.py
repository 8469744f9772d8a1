"""Batched beam search with a KV cache (counterpart of
`gpv_tpu/decode/beam.py`).

Reference `GPV.beam_decode_text` (`exp/gpv/models/gpv.py:256-362`): K
beams; each step every beam proposes its top-K continuations, the K·K
candidates are re-ranked by accumulated log-prob, and at t = 0 all beams
but beam 0 are suppressed (score replaced by -1e9, `:281-282`). The
reference's `seen_stop` freeze is dead code, so a beam keeps accumulating
after `__stop__`, exactly as here and in the JAX package.

All K beams advance as one batch of B·K KV-cached rows; the memory stays
untiled at (B, ·) and the step's cross-attention takes the K beams of a
sample as K query rows (`beam_group`). Ties rank the lower index first, as
`jax.lax.top_k` does, so the (k1, k2) candidate order matches: `torch.topk`
promises no order for ties, a stable descending sort does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..models.gpv import GPV

NEG_INF = -1e9


def top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """(values, indices) of the k largest along the last axis, equal
    values lowest index first (`jax.lax.top_k`'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@torch.inference_mode()
def beam_decode(model: GPV, memory: torch.Tensor,
                mem_valid: Optional[torch.Tensor], cls_id: int,
                beam_size: int, vocab_mask: Optional[torch.Tensor] = None):
    """Beam-search answers for a batch, `max_text_len - 1` steps.

    Args:
      memory: (B, Tm, D) fused decode memory from `GPV.encode`.
      mem_valid: (B, Tm) bool or None.
      beam_size: K >= 1.
      vocab_mask: optional (V,) additive mask.

    Returns:
      seqs: (B, K, T-1) int32 token ids per beam, best first.
      seq_log_prob: (B, K) fp32 accumulated log-probs.
    """
    B, dev = memory.shape[0], memory.device
    K = int(beam_size)
    if K < 1:
        raise ValueError(f"beam_size must be >= 1, got {K}")
    T1 = model.max_text_len - 1
    mem_state = model.precompute_text_memory(memory)
    caches = model.init_text_cache(B * K, dev)
    tok = torch.full((B * K,), cls_id, dtype=torch.long, device=dev)
    seq_log_prob = torch.zeros(B, K, dtype=torch.float32, device=dev)
    seqs = torch.zeros(B, K, T1, dtype=torch.int32, device=dev)
    # row offset of each sample's beams in the B·K batch
    base = (torch.arange(B, device=dev) * K)[:, None]
    for t in range(T1):
        logits = model.text_step(tok, mem_state, mem_valid, caches, t,
                                 beam_group=K)            # (B·K, V)
        if vocab_mask is not None:
            logits = logits + vocab_mask
        logp = torch.log_softmax(logits.float(), dim=-1).view(B, K, -1)
        top_vals, top_ids = top_k_stable(logp, K)          # (B, K, K)
        scores = seq_log_prob[..., None] + top_vals        # (B, K1, K2)
        if t == 0:  # only beam 0 proposes (reference :281-282)
            scores[:, 1:] = NEG_INF
        best_scores, best_idx = top_k_stable(scores.view(B, K * K), K)
        src_beam = torch.div(best_idx, K, rounding_mode="floor")
        new_tok = top_ids.reshape(B, K * K).gather(1, best_idx)  # (B, K)
        # reorder the per-beam state by its source beam: index_select
        # makes new contiguous caches, which later steps write in place
        rows = (base + src_beam).view(-1)
        caches = tuple((ck.index_select(0, rows), cv.index_select(0, rows))
                       for ck, cv in caches)
        seqs = seqs.gather(1, src_beam[..., None].expand(B, K, T1))
        seqs[:, :, t] = new_tok.to(torch.int32)
        tok = new_tok.view(B * K)
        seq_log_prob = best_scores
    return seqs, seq_log_prob
