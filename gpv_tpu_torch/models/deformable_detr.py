"""Deformable DETR as GPV-1's visual stream (Zhu et al., "Deformable DETR",
ICLR 2021; fundamentalvision/Deformable-DETR `models/deformable_detr.py`,
the plain variant of `configs/r50_deformable_detr.sh`).

ResNet-50 with frozen BatchNorm returns C3, C4 and C5 (strides 8, 16 and
32; 512, 1024 and 2048 channels); each goes through a 1x1 conv and
GroupNorm(32) to `hidden_dim`, and every further level (the fourth of the
published four) through a 3x3 stride-2 conv and GroupNorm, from C5 for
the first and from the level before for the rest (`input_proj.{l}.{0,1}`).
Each level takes Deformable DETR's sine position embedding (the counts
offset by half a pixel, `ops.posenc`) over the image's validity mask,
downsampled to the level as DETR's backbone downsamples it.
`nn.deformable_transformer` runs the levels and `num_queries` learned
queries (`query_embed`, (Q, 2 hidden_dim): position, then target).

Heads as GPV-1 reads them: the class head is GPV-1's `num_classes + 1`
logits under a softmax (Deformable DETR's sigmoid focal head is not used:
GPV-1's relevance is added to these logits), and the 3-layer box MLP
predicts a correction to the reference point, boxes =
sigmoid(MLP(hs) + (inverse_sigmoid(ref), 0, 0)), in fp32. The RoI head is
GPV-1's (`models.detr`): aligned 7x7 RoI-align on C5 at the detached
boxes, mean-pooled, a parameter-free LayerNorm, concatenated with the
query states into `detr_hs` (2048 + hidden_dim). The output dict is the
one `models.detr.DETR` returns, so `GPV` reads either detector alike.
Parameter names follow the published ones under GPV's `detr.` prefix
(`backbone.0.body.*`, `input_proj`, `query_embed`, `transformer.*`,
`class_embed`, `bbox_embed.layers.{i}`).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.deformable_transformer import DeformableTransformer
from ..nn.layers import MLP
from ..nn.resnet import ResNet
from ..ops.posenc import sine_position_embedding_2d
from ..ops.roi_align import roi_align_mean_pooled
from .detr import _Body, downsample_valid

TRUNK_LEVELS = ("layer2", "layer3", "layer4")
TRUNK_CHANNELS = (512, 1024, 2048)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """log(x / (1 - x)) with both clamped at `eps` (the published
    `inverse_sigmoid`)."""
    x = x.clamp(0, 1)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


class DeformableDETR(nn.Module):
    def __init__(self, num_queries: int = 300, num_classes: int = 1,
                 hidden_dim: int = 256, nheads: int = 8,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 dim_feedforward: int = 1024,
                 backbone_layers: tuple = (3, 4, 6, 3),
                 num_feature_levels: int = 4, enc_n_points: int = 4,
                 dec_n_points: int = 4, roi_head: bool = True,
                 dropout: float = 0.1, stem_s2d: bool = False,
                 remat: bool = False):
        super().__init__()
        if num_feature_levels < len(TRUNK_LEVELS):
            raise ValueError(f"num_feature_levels={num_feature_levels}: the "
                             f"detector takes C3-C5 and adds levels above "
                             f"them ({len(TRUNK_LEVELS)} or more)")
        self.hidden_dim, self.roi_head = hidden_dim, roi_head
        self.backbone = nn.ModuleList([_Body(ResNet(
            backbone_layers, stem_s2d=stem_s2d, remat=remat,
            return_layers=TRUNK_LEVELS))])
        proj = [nn.Sequential(nn.Conv2d(c, hidden_dim, 1),
                              nn.GroupNorm(32, hidden_dim))
                for c in TRUNK_CHANNELS]
        in_ch = TRUNK_CHANNELS[-1]
        for _ in range(num_feature_levels - len(TRUNK_LEVELS)):
            proj.append(nn.Sequential(
                nn.Conv2d(in_ch, hidden_dim, 3, stride=2, padding=1),
                nn.GroupNorm(32, hidden_dim)))
            in_ch = hidden_dim
        self.input_proj = nn.ModuleList(proj)
        self.query_embed = nn.Embedding(num_queries, 2 * hidden_dim)
        self.transformer = DeformableTransformer(
            hidden_dim, nheads, num_encoder_layers, num_decoder_layers,
            dim_feedforward, num_feature_levels, enc_n_points, dec_n_points,
            dropout, remat)
        self.class_embed = nn.Linear(hidden_dim, num_classes + 1)
        self.bbox_embed = MLP(hidden_dim, hidden_dim, 4, 3)

    @property
    def trunk(self) -> ResNet:
        return self.backbone[0].body

    def forward(self, images: torch.Tensor,
                image_valid: Optional[torch.Tensor] = None,
                train: bool = False) -> dict:
        """images: (B, H, W, 3) normalised; image_valid: (B, H, W) bool.

        Returns {pred_relevance_logits (B,Q,K+1), pred_boxes (B,Q,4) fp32,
        detr_hs (B,Q,2048+D), or (B,Q,D) without the RoI head}."""
        dtype = self.query_embed.weight.dtype
        feats = self.trunk(images.to(dtype).permute(0, 3, 1, 2))
        maps = [feats[name] for name in TRUNK_LEVELS]
        srcs = [proj(x) for proj, x in zip(self.input_proj, maps)]
        for proj in self.input_proj[len(maps):]:
            srcs.append(proj(maps[-1] if len(srcs) == len(maps)
                             else srcs[-1]))
        B = images.shape[0]
        valids = (None if image_valid is None else
                  [downsample_valid(image_valid, *s.shape[-2:])
                   for s in srcs])
        pos = []
        for lvl, s in enumerate(srcs):
            v = (torch.ones(B, *s.shape[-2:], dtype=torch.bool,
                            device=images.device)
                 if valids is None else valids[lvl])
            pos.append(sine_position_embedding_2d(v, self.hidden_dim // 2,
                                                  offset=0.5))
        hs, ref = self.transformer(srcs, pos, self.query_embed.weight,
                                   valids, not train)
        logits = self.class_embed(hs)
        delta = self.bbox_embed(hs)
        with torch.autocast(images.device.type, enabled=False):
            boxes = (delta.float() + F.pad(inverse_sigmoid(ref), (0, 2))
                     ).sigmoid()
        out = {"pred_relevance_logits": logits, "pred_boxes": boxes}
        if not self.roi_head:
            out["detr_hs"] = hs
            return out
        c5 = maps[-1]
        roi = roi_align_mean_pooled(c5, boxes.detach())
        roi = F.layer_norm(roi.to(dtype), roi.shape[-1:], eps=1e-5)
        out["detr_hs"] = torch.cat([roi, hs], dim=-1)
        return out
