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
`configs/exp/gpv.yaml`; `build_gpv(cfg, vocab_size)` builds from that node
with the JAX package's config checks. `forward(..., train=True)` is the
teacher-forced training forward: dropout where the JAX modules have it,
the training attention route in DETR, co-attention and the text decoder,
and DETR's aux outputs when configured; BERT stays frozen and
deterministic in every mode (it always takes K1). Variants the node can
select: `answer_head:
linear` (a Linear classifier in place of the vocab-embedding one),
`roi_head: False`, `relevance_conditioning: False`, the learned DETR
position embedding and any `backbone_layers`.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ..nn.bert import BertEncoder
from ..nn.coattention import CoAttentionLayer
from ..nn.text_decoder import TextDecoder
from ..ops.posenc import sine_position_encoding_1d
from .detr import DETR, POSITION_EMBEDDINGS


class _AnswerHead(nn.Module):
    """Fixed vocab embedding + learned classifier transform (reference
    AnswerHead, answer_head.py:8-33), or with `linear` a Linear
    classifier over the decoder state (`answer_head.classifier`)."""

    def __init__(self, vocab_size: int, dim: int, linear: bool = False):
        super().__init__()
        self.vocab_embed = nn.Parameter(torch.zeros(vocab_size, dim),
                                        requires_grad=False)
        if linear:
            self.classifier = nn.Linear(dim, vocab_size)
        else:
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
                 text_pos_enc: bool = False,
                 relevance_conditioning: bool = True,
                 mask_query_pads: bool = True,
                 answer_head: Optional[str] = None,
                 co_att_num_layers: int = 3, co_att_heads: int = 16,
                 co_att_intermediate: int = 3072,
                 co_att_extra: Optional[Dict[str, Any]] = None,
                 dropout: float = 0.1,
                 text_decoder_layers: int = 3, text_decoder_heads: int = 8,
                 text_decoder_dropout: Optional[float] = None,
                 detr_cfg: Optional[Dict[str, Any]] = None,
                 roi_head: bool = True, bert_layers: int = 12,
                 bert_hidden: int = 768, bert_heads: int = 12,
                 bert_vocab_size: int = 30522, bert_max_len: int = 512):
        super().__init__()
        detr_cfg = dict(detr_cfg or {})
        self.vocab_size, self.hidden_dim = vocab_size, hidden_dim
        self.max_text_len = max_text_len
        self.text_pos_enc = text_pos_enc
        self.relevance_conditioning = relevance_conditioning
        self.mask_query_pads = mask_query_pads
        self.linear_answer_head = answer_head == "linear"
        self.bert_max_len = bert_max_len
        self.detr = DETR(roi_head=roi_head, **detr_cfg)
        # query states (+ the 2048-d RoI features)
        self.detr_joiner = nn.Linear(
            detr_cfg.get("hidden_dim", 256) + (2048 if roi_head else 0),
            hidden_dim)
        self.bert = BertEncoder(bert_layers, bert_hidden, bert_heads,
                                4 * bert_hidden, bert_vocab_size,
                                bert_max_len)
        self.bert_joiner = nn.Linear(bert_hidden, hidden_dim)
        co_att_kwargs = {"dropout": dropout, **(co_att_extra or {})}
        self.co_att_transformer = nn.ModuleList(
            CoAttentionLayer(hidden_dim, co_att_heads, co_att_intermediate,
                             **co_att_kwargs)
            for _ in range(co_att_num_layers))
        self.relevance_predictor = nn.Linear(
            hidden_dim, detr_cfg.get("num_classes", 1) + 1)
        self.text_decoder = TextDecoder(
            hidden_dim, text_decoder_heads, text_decoder_layers,
            dropout=(dropout if text_decoder_dropout is None
                     else text_decoder_dropout))
        self.answer_head = _AnswerHead(vocab_size, hidden_dim,
                                       self.linear_answer_head)
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
        """Frozen BERT: (N, Tl) ids -> (N, Tl, 768), without a gradient.
        BERT runs deterministic in every mode (so through K1), and the
        train step calls this on the batch's unique query rows alone."""
        with torch.no_grad():
            return self.bert(query_ids, query_valid)

    def encode(self, images, query_ids, image_valid=None, query_valid=None,
               train: bool = False, query_enc=None):
        """images (B,H,W,3) normalised, query_ids (B,Tl). `query_enc`
        (B,Tl,768), when given, is an `encode_queries` output and BERT is
        skipped. Returns (memory (B,Q+Tl,D), mem_valid (B,Q+Tl) or None,
        outputs)."""
        outputs = self.detr(images, image_valid, train)
        vl_hs = self.detr_joiner(outputs.pop("detr_hs"))     # (B,Q,D)
        if query_enc is None:
            query_enc = self.encode_queries(query_ids, query_valid)
        lv_hs = self.bert_joiner(query_enc)
        # mask_query_pads=True: padded query positions are invisible to
        # fusion and decode; False: the reference's batched no-mask
        # semantics (PARITY.md #12)
        fusion_valid = query_valid if self.mask_query_pads else None
        for layer in self.co_att_transformer:
            lv_hs, vl_hs = layer(lv_hs, vl_hs, fusion_valid, None, not train)
        relevance = self.relevance_predictor(vl_hs)
        outputs["pred_relevance_logits"] = (
            outputs["pred_relevance_logits"] + relevance)
        if "aux_pred_relevance_logits" in outputs:
            outputs["aux_pred_relevance_logits"] = (
                outputs["aux_pred_relevance_logits"] + relevance[None])
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
        if not self.relevance_conditioning:
            return fused_hs
        prob = relevance_logits.softmax(-1)                    # (B,Q,2)
        return fused_hs + prob @ self.relevance_tokens.to(prob.dtype)

    # ---------------- answer text machinery ----------------

    def embed_answer_tokens(self, token_ids):
        """(..., S) ids -> (..., S, D): frozen vocab embed + learned Linear."""
        emb = self.answer_head.vocab_embed.detach()[token_ids]
        return self.answer_input_embedings.transform(emb)

    def answer_classifier(self) -> Optional[torch.Tensor]:
        """(V, D) fp32 classifier matrix, hoisted out of the decode loop;
        None with the linear head."""
        head = self.answer_head
        if self.linear_answer_head:
            return None
        return head.classifier_transform(head.vocab_embed.detach()).float()

    def answer_logits_head(self, h, classifier=None):
        """(..., D) decoder states -> (..., V) fp32 vocab logits (an fp32
        product, also under autocast)."""
        if self.linear_answer_head:
            return self.answer_head.classifier(h).float()
        w = classifier if classifier is not None else self.answer_classifier()
        with torch.autocast(h.device.type, enabled=False):
            return h.float() @ w.float().t()

    def decode_text(self, target_embed, memory, mem_valid=None,
                    train: bool = False):
        """Teacher-forced causal decode: (B,S,D) -> (B,S,V)."""
        if self.text_pos_enc:
            S = target_embed.shape[1]
            target_embed = target_embed + self.pos_enc_table[:S].to(
                target_embed.dtype)
        return self.answer_logits_head(
            self.text_decoder(target_embed, memory, mem_valid, not train))

    def forward(self, images, query_ids, answer_ids=None, image_valid=None,
                query_valid=None, train: bool = False, query_enc=None):
        """The reference `outputs` dict; with `answer_ids` (B,S),
        `answer_logits` (B,S-1,V) are the teacher-forced logits. `train`
        and `query_enc` as in `encode`."""
        memory, mem_valid, outputs = self.encode(
            images, query_ids, image_valid, query_valid, train, query_enc)
        if answer_ids is not None:
            logits = self.decode_text(self.embed_answer_tokens(answer_ids),
                                      memory, mem_valid, train)
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

    def text_step(self, token_t, mem_state, mem_valid, caches, t: int,
                  beam_group: int = 1):
        """(B,) ids at position t -> (B,V) fp32 logits; caches in place.

        beam_group K > 1: token_t and the caches hold B·K sample-major beam
        rows while mem_state/mem_valid stay untiled at (B, ·)
        (`TextDecoderLayer.step`)."""
        mem_kvs, classifier = mem_state
        x_t = self.embed_answer_tokens(token_t[:, None])      # (B,1,D)
        if self.text_pos_enc:
            x_t = x_t + self.pos_enc_table[t].to(x_t.dtype)
        y = self.text_decoder.step(x_t, mem_kvs, mem_valid, caches, t,
                                   beam_group)
        return self.answer_logits_head(y[:, 0], classifier)

    def init_text_cache(self, batch: int, device):
        return self.text_decoder.init_cache(batch, self.max_text_len,
                                            self.dtype, device)


_BACKBONE_LAYERS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3),
                    "resnet152": (3, 8, 36, 3), "resnet26": (2, 2, 2, 2),
                    "resnet14": (1, 1, 1, 1)}


def _check_co_att(cfg):
    """Map the ViLBERT `co_att` schema onto CoAttentionLayer arguments:
    (intermediate, {intermediate2, act, act2}).

    The reference feeds stream 1 (text in GPV's call order) through its
    `v_*` weights and stream 2 through the plain ones (vilbert.py:827-900);
    the mapping keeps that. Untied per-stream widths are not representable
    and raise. Dropouts are inference no-ops and are not read.
    """
    co = cfg.co_att
    hd = int(cfg.hidden_dim)
    for key in ("bi_hidden_size", "hidden_size", "v_hidden_size",
                "output_size", "v_output_size"):
        val = co.get(key)
        if val is not None and int(val) != hd:
            raise ValueError(
                f"model.co_att.{key}={val} != model.hidden_dim={hd}: untied "
                "co-attention stream widths are not supported (GPV always "
                "ties them — reference configs/exp/gpv.yaml interpolations)")
    for key in ("hidden_act", "v_hidden_act"):
        act = co.get(key, "gelu")
        if act not in ("gelu", "relu", "swish"):
            raise ValueError(f"model.co_att.{key}={act!r}: unsupported "
                             "co-attention activation (gelu/relu/swish)")
    dflt = float(cfg.detr.dropout)
    extra = dict(
        intermediate2=int(co.get("intermediate_size", 3072)),
        dropout2=float(co.get("hidden_dropout_prob", dflt)),
        attn_dropout=float(co.get("v_attention_probs_dropout_prob", dflt)),
        attn_dropout2=float(co.get("attention_probs_dropout_prob", dflt)),
        act=str(co.get("v_hidden_act", "gelu")),
        act2=str(co.get("hidden_act", "gelu")),
        dropout=float(co.get("v_hidden_dropout_prob", dflt)))
    intermediate = int(co.get("v_intermediate_size",
                              co.get("intermediate_size", 3072)))
    return intermediate, extra


def build_gpv(cfg, vocab_size: int) -> GPV:
    """Build from the `model` config node (configs/exp/gpv.yaml schema),
    with the checks and messages of `gpv_tpu.models.gpv.build_gpv`."""
    if cfg.detr.get("masks"):
        raise ValueError(
            "model.detr.masks=True (DETR segmentation head) is not part of "
            "GPV (the reference never trains it; detr.py builds DETRsegm "
            "only for panoptic) — unsupported here")
    if cfg.detr.get("frozenbatchnorm", True) is False:
        raise ValueError(
            "model.detr.frozenbatchnorm=False is not supported: the "
            "backbone is built around FrozenBN (reference backbone.py "
            "always freezes BN for GPV; serving-path BN folding depends "
            "on it)")
    backbone = str(cfg.detr.get("backbone", "resnet50"))
    if backbone not in _BACKBONE_LAYERS:
        raise ValueError(f"model.detr.backbone={backbone!r} not supported "
                         f"(one of {sorted(_BACKBONE_LAYERS)})")
    pe = str(cfg.detr.get("position_embedding", "sine"))
    if pe not in POSITION_EMBEDDINGS:
        raise ValueError(f"model.detr.position_embedding={pe!r} not "
                         "supported (sine/v2 or learned/v3)")
    if cfg.roi_head and not cfg.detr.last_layer_only:
        raise ValueError(
            "model.roi_head=True with detr.last_layer_only=False is not a "
            "trainable configuration (it crashes the reference at "
            "detr_roi_head.py:90-92); set last_layer_only=True or "
            "roi_head=False")
    if cfg.detr.get("stem_s2d"):
        raise NotImplementedError(
            "model.detr.stem_s2d=True (space-to-depth stem rewrite) is not "
            "ported to gpv_tpu_torch: ROADMAP Queue 1 item 21, on H100 "
            "evidence only; unset it (the stem computes the same function)")
    detr_cfg = dict(
        num_queries=int(cfg.detr.num_queries),
        num_classes=int(cfg.detr.num_classes),
        hidden_dim=int(cfg.detr.hidden_dim),
        nheads=int(cfg.detr.nheads),
        num_encoder_layers=int(cfg.detr.num_encoder_layers),
        num_decoder_layers=int(cfg.detr.num_decoder_layers),
        dim_feedforward=int(cfg.detr.dim_feedforward),
        dilation=bool(cfg.detr.dilation),
        pre_norm=bool(cfg.detr.get("pre_norm", False)),
        position_embedding=pe,
        dropout=float(cfg.detr.dropout),
        aux_loss=bool(cfg.detr.aux_loss),
        last_layer_only=bool(cfg.detr.last_layer_only))
    if cfg.detr.get("backbone_layers"):
        # an explicit block spec wins over the backbone's name
        detr_cfg["backbone_layers"] = tuple(
            int(x) for x in cfg.detr.backbone_layers)
    else:
        detr_cfg["backbone_layers"] = _BACKBONE_LAYERS[backbone]
    bert_cfg = cfg.get("bert") or {}
    co_att_intermediate, co_att_extra = _check_co_att(cfg)
    if cfg.co_att.get("visualization"):
        raise ValueError(
            "model.co_att.visualization=True (return attention-probability "
            "maps from fusion, vilbert.py:786-800) is not implemented; "
            "unset it rather than silently losing the diagnostics")
    hd = int(cfg.hidden_dim)
    td_hidden = int(cfg.text_decoder.get("hidden_dim", hd))
    if td_hidden != hd:
        raise ValueError(
            f"model.text_decoder.hidden_dim={td_hidden} != "
            f"model.hidden_dim={hd}: the decoder width is tied to the "
            "fusion width (reference gpv.yaml interpolation)")
    exp_detr_dim = int(cfg.detr.hidden_dim) + (2048 if cfg.roi_head else 0)
    joiner = cfg.get("detr_joiner") or {}
    jd = joiner.get("detr_dim")
    if jd is not None and int(jd) != exp_detr_dim:
        raise ValueError(
            f"model.detr_joiner.detr_dim={jd} but the DETR stream emits "
            f"{exp_detr_dim} features (detr.hidden_dim"
            f"{' + 2048 RoI' if cfg.roi_head else ''})")
    for node, key, want, why in (
            ("detr_joiner", "out_dim", hd, "fusion width"),
            ("bert_joiner", "out_dim", hd, "fusion width"),
            ("bert_joiner", "bert_dim", int(bert_cfg.get("hidden", 768)),
             "BERT hidden size")):
        val = (cfg.get(node) or {}).get(key)
        if val is not None and int(val) != want:
            raise ValueError(f"model.{node}.{key}={val} != {want} "
                             f"({why})")
    return GPV(
        vocab_size=vocab_size,
        hidden_dim=hd,
        max_text_len=int(cfg.max_text_len),
        max_pos_enc_len=int(cfg.max_pos_enc_len),
        text_pos_enc=bool(cfg.text_decoder.pos_enc),
        relevance_conditioning=bool(cfg.relevance_conditioning),
        mask_query_pads=bool(cfg.get("mask_query_pads", True)),
        answer_head=cfg.answer_head,
        co_att_num_layers=int(cfg.co_att.num_layers),
        co_att_heads=int(cfg.co_att.bi_num_attention_heads),
        co_att_intermediate=co_att_intermediate,
        co_att_extra=co_att_extra,
        dropout=float(cfg.detr.dropout),
        text_decoder_layers=int(cfg.text_decoder.num_layers),
        text_decoder_heads=int(cfg.text_decoder.nheads),
        text_decoder_dropout=float(
            cfg.text_decoder.get("dropout", cfg.detr.dropout)),
        detr_cfg=detr_cfg,
        roi_head=bool(cfg.roi_head),
        bert_layers=int(bert_cfg.get("num_layers", 12)),
        bert_hidden=int(bert_cfg.get("hidden", 768)),
        bert_heads=int(bert_cfg.get("heads", 12)),
        bert_vocab_size=int(bert_cfg.get("vocab_size", 30522)),
        bert_max_len=int(bert_cfg.get("max_len", 512)))
