"""GPV-1 top-level model: image + query -> boxes, relevance, answer text
(counterpart of `gpv_tpu/models/gpv.py`).

Reference `exp/gpv/models/gpv.py` `GPV`: DETR(+RoI) visual stream ->
`detr_joiner` 2304->768; frozen BERT text stream -> `bert_joiner`
768->768; 3 co-attention layers (text stream 1, vision stream 2);
relevance head 768->2 added to the DETR class logits; relevance
conditioning (softmax blend of 2 learned tokens added to the vision
states); text decoder over memory = [vision states, text states] with the
vocab-embedding answer head. Parameter names follow the reference state
dict (`detr.*`, `bert.model.*`, `co_att_transformer.{i}.*`,
`text_decoder.layers.{i}.*`, `answer_head.*`,
`answer_input_embedings.transform`, ...).

Defaults are the released widths of the `model` node of
`configs/exp/gpv.yaml`. Building from a config node waits for a later
slice; this module is inference-only (no dropout, no aux losses) and
builds the released head: RoI features, relevance conditioning and the
vocab-embedding answer classifier are always on.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ..nn.bert import BertEncoder
from ..nn.coattention import CoAttentionLayer
from ..nn.text_decoder import TextDecoder
from ..ops.posenc import sine_position_encoding_1d
from .detr import DETR


class _AnswerHead(nn.Module):
    """Fixed vocab embedding + learned classifier transform (reference
    AnswerHead, answer_head.py:8-33)."""

    def __init__(self, vocab_size: int, dim: int):
        super().__init__()
        self.vocab_embed = nn.Parameter(torch.zeros(vocab_size, dim),
                                        requires_grad=False)
        self.classifier_transform = nn.Linear(dim, dim)


class _AnswerInput(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.transform = nn.Linear(dim, dim)


class GPV(nn.Module):
    """Flagship model, released widths by default. Weights come from
    `load_state_dict` (see `gpv_tpu_torch.weights`) or
    `weights.init_random`."""

    def __init__(self, vocab_size: int, hidden_dim: int = 768,
                 max_text_len: int = 20, max_pos_enc_len: int = 30,
                 text_pos_enc: bool = False, mask_query_pads: bool = True,
                 co_att_num_layers: int = 3, co_att_heads: int = 16,
                 co_att_intermediate: int = 3072,
                 co_att_extra: Optional[Dict[str, Any]] = None,
                 text_decoder_layers: int = 3, text_decoder_heads: int = 8,
                 detr_cfg: Optional[Dict[str, Any]] = None,
                 bert_layers: int = 12,
                 bert_hidden: int = 768, bert_heads: int = 12,
                 bert_vocab_size: int = 30522, bert_max_len: int = 512):
        super().__init__()
        detr_cfg = dict(detr_cfg or {})
        self.vocab_size, self.hidden_dim = vocab_size, hidden_dim
        self.max_text_len = max_text_len
        self.text_pos_enc = text_pos_enc
        self.mask_query_pads = mask_query_pads
        self.bert_max_len = bert_max_len
        self.detr = DETR(**detr_cfg)
        # query states + the 2048-d RoI features
        self.detr_joiner = nn.Linear(detr_cfg.get("hidden_dim", 256) + 2048,
                                     hidden_dim)
        self.bert = BertEncoder(bert_layers, bert_hidden, bert_heads,
                                4 * bert_hidden, bert_vocab_size,
                                bert_max_len)
        self.bert_joiner = nn.Linear(bert_hidden, hidden_dim)
        self.co_att_transformer = nn.ModuleList(
            CoAttentionLayer(hidden_dim, co_att_heads, co_att_intermediate,
                             **(co_att_extra or {}))
            for _ in range(co_att_num_layers))
        self.relevance_predictor = nn.Linear(
            hidden_dim, detr_cfg.get("num_classes", 1) + 1)
        self.text_decoder = TextDecoder(hidden_dim, text_decoder_heads,
                                        text_decoder_layers)
        self.answer_head = _AnswerHead(vocab_size, hidden_dim)
        self.answer_input_embedings = _AnswerInput(hidden_dim)
        # vision/lang tokens: kept for checkpoint parity, unused upstream
        self.vision_token = nn.Parameter(torch.zeros(hidden_dim))
        self.lang_token = nn.Parameter(torch.zeros(hidden_dim))
        self.relevance_tokens = nn.Parameter(torch.zeros(2, hidden_dim))
        self.register_buffer("pos_enc_table", sine_position_encoding_1d(
            hidden_dim, max_pos_enc_len), persistent=False)

    @property
    def dtype(self) -> torch.dtype:
        return self.detr_joiner.weight.dtype

    # ---------------- encoding ----------------

    def encode_queries(self, query_ids, query_valid=None):
        """Frozen BERT: (N, Tl) ids -> (N, Tl, 768), detached."""
        return self.bert(query_ids, query_valid).detach()

    def encode(self, images, query_ids, image_valid=None, query_valid=None):
        """images (B,H,W,3) normalised, query_ids (B,Tl).
        Returns (memory (B,Q+Tl,D), mem_valid (B,Q+Tl) or None, outputs)."""
        outputs = self.detr(images, image_valid)
        vl_hs = self.detr_joiner(outputs.pop("detr_hs"))     # (B,Q,D)
        lv_hs = self.bert_joiner(self.encode_queries(query_ids, query_valid))
        # mask_query_pads=True: padded query positions are invisible to
        # fusion and decode; False: the reference's batched no-mask
        # semantics (PARITY.md #12)
        fusion_valid = query_valid if self.mask_query_pads else None
        for layer in self.co_att_transformer:
            lv_hs, vl_hs = layer(lv_hs, vl_hs, fusion_valid, None)
        outputs["pred_relevance_logits"] = (
            outputs["pred_relevance_logits"] + self.relevance_predictor(vl_hs))
        vl_hs = self.condition_on_relevance(outputs["pred_relevance_logits"],
                                            vl_hs)
        memory = torch.cat([vl_hs, lv_hs], dim=1)
        mem_valid = None
        if fusion_valid is not None:
            B, Q = vl_hs.shape[:2]
            mem_valid = torch.cat([torch.ones(B, Q, dtype=torch.bool,
                                              device=memory.device),
                                   fusion_valid], dim=1)
        return memory, mem_valid, outputs

    def condition_on_relevance(self, relevance_logits, fused_hs):
        prob = relevance_logits.softmax(-1)                    # (B,Q,2)
        return fused_hs + prob @ self.relevance_tokens.to(prob.dtype)

    # ---------------- answer text machinery ----------------

    def embed_answer_tokens(self, token_ids):
        """(..., S) ids -> (..., S, D): frozen vocab embed + learned Linear."""
        emb = self.answer_head.vocab_embed.detach()[token_ids]
        return self.answer_input_embedings.transform(emb)

    def answer_classifier(self) -> torch.Tensor:
        """(V, D) fp32 classifier matrix, hoisted out of the decode loop."""
        head = self.answer_head
        return head.classifier_transform(head.vocab_embed.detach()).float()

    def answer_logits_head(self, h, classifier=None):
        """(..., D) decoder states -> (..., V) fp32 vocab logits."""
        w = classifier if classifier is not None else self.answer_classifier()
        return h.float() @ w.t()

    def decode_text(self, target_embed, memory, mem_valid=None):
        """Teacher-forced causal decode: (B,S,D) -> (B,S,V)."""
        if self.text_pos_enc:
            S = target_embed.shape[1]
            target_embed = target_embed + self.pos_enc_table[:S].to(
                target_embed.dtype)
        return self.answer_logits_head(
            self.text_decoder(target_embed, memory, mem_valid))

    def forward(self, images, query_ids, answer_ids=None, image_valid=None,
                query_valid=None):
        """The reference `outputs` dict; with `answer_ids` (B,S),
        `answer_logits` (B,S-1,V) are the teacher-forced logits."""
        memory, mem_valid, outputs = self.encode(images, query_ids,
                                                 image_valid, query_valid)
        if answer_ids is not None:
            logits = self.decode_text(self.embed_answer_tokens(answer_ids),
                                      memory, mem_valid)
            outputs["answer_logits"] = logits[:, :-1]
        outputs["memory"] = memory
        if mem_valid is not None:
            outputs["memory_valid"] = mem_valid
        return outputs

    # ---------------- incremental decode hooks ----------------

    def precompute_text_memory(self, memory):
        """Per-layer cross-attention K/V plus the classifier matrix."""
        return (self.text_decoder.precompute_memory(memory),
                self.answer_classifier())

    def text_step(self, token_t, mem_state, mem_valid, caches, t: int):
        """(B,) ids at position t -> (B,V) fp32 logits; caches in place."""
        mem_kvs, classifier = mem_state
        x_t = self.embed_answer_tokens(token_t[:, None])      # (B,1,D)
        if self.text_pos_enc:
            x_t = x_t + self.pos_enc_table[t].to(x_t.dtype)
        y = self.text_decoder.step(x_t, mem_kvs, mem_valid, caches, t)
        return self.answer_logits_head(y[:, 0], classifier)

    def init_text_cache(self, batch: int, device):
        return self.text_decoder.init_cache(batch, self.max_text_len,
                                            self.dtype, device)
