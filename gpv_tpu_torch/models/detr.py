"""DETR detector with RoI head, the GPV visual stream (counterpart of
`gpv_tpu/models/detr.py`).

Reference `exp/gpv/models/detr.py` + `detr_roi_head.py`: ResNet-50 C5 ->
1x1 `input_proj` to 256 -> DETR transformer -> query states; class head
(num_classes + 1 logits) and 3-layer sigmoid cxcywh box MLP; RoI head:
aligned 7x7 RoI-align on C5 at the detached predicted boxes, mean-pooled,
parameter-free LayerNorm (eps 1e-5), concatenated with the query states to
the 2304-d `detr_hs`. Parameter names follow the reference
(`backbone.0.body.*`, `input_proj`, `query_embed`, `class_embed`,
`bbox_embed.layers.{i}`). The position embedding is the sine one or the
learned one (`backbone.1.row_embed` / `col_embed`, the reference Joiner's
slot); `roi_head=False` drops the RoI features (`detr_hs` is then the
query states alone). The RoI head runs at its released setting (7x7,
sampling grid capped at 8). In training (`train=True`) the transformer
applies its dropout and the training attention route; with `aux_loss` and
not `last_layer_only` it also returns every earlier decoder layer's
predictions for the aux losses. `stem_s2d` builds the space-to-depth stem
(`ops.stem_s2d`); `remat` recomputes the backbone's stages and the
transformer's layers in the backward.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.detr_transformer import DetrTransformer
from ..nn.layers import MLP
from ..nn.resnet import ResNet
from ..ops.posenc import LearnedPositionEmbedding2D, sine_position_embedding_2d
from ..ops.roi_align import roi_align_mean_pooled

POSITION_EMBEDDINGS = ("sine", "v2", "learned", "v3")


def downsample_valid(image_valid: torch.Tensor, h: int,
                     w: int) -> torch.Tensor:
    """Nearest downsample of a (B, H, W) validity mask to (B, h, w)
    (reference backbone.py:77), index arithmetic in fp32 as in the JAX
    package."""
    H, W = image_valid.shape[1:]
    dev = image_valid.device
    ys = (torch.arange(h, device=dev, dtype=torch.float32) * (H / h)).long()
    xs = (torch.arange(w, device=dev, dtype=torch.float32) * (W / w)).long()
    return image_valid[:, ys][:, :, xs]


class _Body(nn.Module):
    """Holds the trunk as `body`, so its names read `backbone.0.body.*`."""

    def __init__(self, body: ResNet):
        super().__init__()
        self.body = body


class DETR(nn.Module):
    def __init__(self, num_queries: int = 100, num_classes: int = 1,
                 hidden_dim: int = 256, nheads: int = 8,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 dim_feedforward: int = 2048,
                 backbone_layers: tuple = (3, 4, 6, 3),
                 dilation: bool = False, pre_norm: bool = False,
                 roi_head: bool = True, position_embedding: str = "sine",
                 dropout: float = 0.1, aux_loss: bool = False,
                 last_layer_only: bool = True, stem_s2d: bool = False,
                 remat: bool = False):
        super().__init__()
        self.aux_loss, self.last_layer_only = aux_loss, last_layer_only
        if position_embedding not in POSITION_EMBEDDINGS:
            raise ValueError(f"not supported {position_embedding!r} "
                             "(expected sine/v2 or learned/v3)")
        self.hidden_dim = hidden_dim
        self.roi_head = roi_head
        self.backbone = nn.ModuleList(
            [_Body(ResNet(backbone_layers, dilate_c5=dilation,
                          stem_s2d=stem_s2d, remat=remat))])
        if position_embedding in ("learned", "v3"):
            self.backbone.append(LearnedPositionEmbedding2D(hidden_dim // 2))
        self.input_proj = nn.Conv2d(2048, hidden_dim, 1)
        self.query_embed = nn.Embedding(num_queries, hidden_dim)
        self.transformer = DetrTransformer(
            hidden_dim, nheads, num_encoder_layers, num_decoder_layers,
            dim_feedforward, pre_norm, dropout, remat)
        self.class_embed = nn.Linear(hidden_dim, num_classes + 1)
        self.bbox_embed = MLP(hidden_dim, hidden_dim, 4, 3)

    @property
    def trunk(self) -> ResNet:
        return self.backbone[0].body

    def forward(self, images: torch.Tensor,
                image_valid: Optional[torch.Tensor] = None,
                train: bool = False) -> dict:
        """images: (B, H, W, 3) normalised; image_valid: (B, H, W) bool.

        Returns {pred_relevance_logits (B,Q,K+1), pred_boxes (B,Q,4),
        detr_hs (B,Q,2048+D), or (B,Q,D) without the RoI head}, plus
        aux_pred_relevance_logits (L-1,B,Q,K+1) and aux_pred_boxes
        (L-1,B,Q,4) when the aux losses are on in training.
        """
        B = images.shape[0]
        dtype = self.input_proj.weight.dtype
        # NHWC -> NCHW view: the memory stays channels-last for cuDNN
        feats = self.trunk(images.to(dtype).permute(0, 3, 1, 2))
        h, w = feats.shape[-2:]
        if image_valid is None:
            feat_valid = torch.ones(B, h, w, dtype=torch.bool,
                                    device=images.device)
        else:
            feat_valid = downsample_valid(image_valid, h, w)
        if len(self.backbone) > 1:
            pos = self.backbone[1](B, h, w)
        else:
            pos = sine_position_embedding_2d(feat_valid, self.hidden_dim // 2)

        src = self.input_proj(feats).flatten(2).transpose(1, 2)  # (B,hw,D)
        pos = pos.reshape(B, h * w, self.hidden_dim).to(dtype)
        key_valid = (None if image_valid is None
                     else feat_valid.reshape(B, h * w).contiguous())
        aux = self.aux_loss and train and not self.last_layer_only
        hs, _ = self.transformer(src, pos, self.query_embed.weight,
                                 key_valid, not train, aux)
        logits, boxes = self.class_embed(hs), self.bbox_embed(hs).sigmoid()
        if aux:
            hs = hs[-1]
            out = {"pred_relevance_logits": logits[-1],
                   "pred_boxes": boxes[-1],
                   "aux_pred_relevance_logits": logits[:-1],
                   "aux_pred_boxes": boxes[:-1]}
        else:
            out = {"pred_relevance_logits": logits, "pred_boxes": boxes}
        if not self.roi_head:
            out["detr_hs"] = hs
            return out
        # no gradient into the box coordinates (torchvision's roi_align has
        # none for the rois, detr_roi_head.py:45-55)
        roi = roi_align_mean_pooled(feats, out["pred_boxes"].detach())
        roi = F.layer_norm(roi.to(dtype), roi.shape[-1:], eps=1e-5)
        out["detr_hs"] = torch.cat([roi, hs], dim=-1)
        return out


def detr_from_config(cfg, roi_head: bool, dtype=torch.float32,
                     device=None) -> DETR:
    """DETR from the `model.detr` config node (configs/exp/gpv.yaml schema),
    as `gpv_tpu.models.detr.detr_from_config` builds it (the same fields;
    the ResNet-50 trunk), cast to `dtype` on `device`: the card unless the
    caller asks for the CPU."""
    from ..engine import resolve_device
    return DETR(
        num_queries=int(cfg.num_queries),
        num_classes=int(cfg.num_classes),
        hidden_dim=int(cfg.hidden_dim),
        nheads=int(cfg.nheads),
        num_encoder_layers=int(cfg.num_encoder_layers),
        num_decoder_layers=int(cfg.num_decoder_layers),
        dim_feedforward=int(cfg.dim_feedforward),
        dropout=float(cfg.dropout),
        dilation=bool(cfg.dilation),
        last_layer_only=bool(cfg.last_layer_only),
        aux_loss=bool(cfg.aux_loss),
        roi_head=roi_head,
        position_embedding=str(cfg.get("position_embedding", "sine")),
        pre_norm=bool(cfg.get("pre_norm", False))).to(
            device=resolve_device(device), dtype=dtype)
