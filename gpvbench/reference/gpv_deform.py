"""GPV-1 on Deformable DETR written out in plain PyTorch: the yardstick of
the configurations of family `gpv_deform`.

The visual stream follows the published plain Deformable DETR
(fundamentalvision/Deformable-DETR, `configs/r50_deformable_detr.sh` with
`main.py`'s defaults; `models/deformable_detr.py`,
`models/deformable_transformer.py`, `models/ops/functions/
ms_deform_attn_func.py` `ms_deform_attn_core_pytorch`,
`models/position_encoding.py`) from the configuration's `model` node:
ResNet C3-C5 with frozen BatchNorm, a fourth level by a 3x3 stride-2 conv
on C5, each level projected to 256 and GroupNorm(32); the sine position
embedding over each level's mask with the counts offset by half a pixel,
plus a learned level embedding; 6 post-norm encoder layers of multi-scale
deformable self-attention over the pixel centres; 6 decoder layers of
self-attention and deformable cross-attention from sigmoid reference
points; boxes as sigmoid(MLP + (inverse_sigmoid(reference), 0, 0)). The
rest is GPV-1's and is taken from `reference/gpv.py` (through
`family.reference`), unchanged: the RoI
head on C5, the joiners, BERT, co-attention, the relevance conditioning
and the answer decoder.

The sampling is the published `ms_deform_attn_core_pytorch`: one
`grid_sample` a level (bilinear, zero padding, align_corners=False) over
the value's heads, then the weighted sum over the L x P samples. Where it
departs from the published code:

- GPV-1's class head (`num_classes + 1` logits under a softmax, to which
  GPV-1 adds its relevance) stands where Deformable DETR has a sigmoid
  focal-loss head;
- `Precision` rounds the sampling's two operands, the value and the
  attention weights, as it rounds every product's (`reference/gpv.py`);
  the locations, the softmax and the sums stay fp32;
- the encoder runs in blocks of `ENCODER_BLOCK` images, so that the
  reference fits on the card beside the program; every image's numbers
  are its own.

`param_spec` gives GPV-1's weights (`reference/gpv.py`) with DETR's
input projection, queries and transformer replaced by Deformable DETR's;
`query_embed` and `level_embed` are drawn N(0, 1), as the published code
initialises them (`make_weights`). Nothing of the program is imported.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .. import family

# GPV-1's parts, found through the family lookup as the harness finds them
gpv = family.reference({"family": "gpv"})
IMAGENET_MEAN, IMAGENET_STD = gpv.IMAGENET_MEAN, gpv.IMAGENET_STD
Precision, tokenize, answer_logits = (gpv.Precision, gpv.tokenize,
                                      gpv.answer_logits)
bert_forward, coattention_layer, dense = (gpv.bert_forward,
                                          gpv.coattention_layer, gpv.dense)
frozen_bn, layer_norm, roi_align_mean = (gpv.frozen_bn, gpv.layer_norm,
                                         gpv.roi_align_mean)

ENCODER_BLOCK = 4
TRUNK_CHANNELS = (512, 1024, 2048)
DETR_ONLY = ("detr.input_proj.", "detr.query_embed.", "detr.transformer.")


def deform_dims(model: dict) -> Tuple[int, int, int]:
    """(levels, encoder points, decoder points)."""
    node = model.get("deformable_detr") or {}
    return (int(node.get("num_feature_levels", 4)),
            int(node.get("enc_n_points", 4)),
            int(node.get("dec_n_points", 4)))


def _msdeform_spec(spec, name, d, heads, levels, points):
    gpv._linear(spec, f"{name}.sampling_offsets", heads * levels * points * 2,
                d)
    gpv._linear(spec, f"{name}.attention_weights", heads * levels * points, d)
    gpv._linear(spec, f"{name}.value_proj", d, d)
    gpv._linear(spec, f"{name}.output_proj", d, d)


def param_spec(model: dict, vocab_size: int) -> List[tuple]:
    """[(name, shape, kind)] of every weight: `reference/gpv.py`'s, with
    DETR's input projection, queries and transformer replaced by Deformable
    DETR's (kind "unit": N(0, 1))."""
    detr = model["detr"]
    d, heads = int(detr["hidden_dim"]), int(detr["nheads"])
    ff = int(detr["dim_feedforward"])
    levels, enc_points, dec_points = deform_dims(model)
    base = [e for e in gpv.param_spec(model, vocab_size)
            if not e[0].startswith(DETR_ONLY)]
    cut = max(i for i, e in enumerate(base)
              if e[0].startswith("detr.backbone.")) + 1
    spec: List[tuple] = []
    in_ch = TRUNK_CHANNELS[-1]
    for lvl in range(levels):
        if lvl < len(TRUNK_CHANNELS):
            shape = (d, TRUNK_CHANNELS[lvl], 1, 1)
        else:
            shape, in_ch = (d, in_ch, 3, 3), d
        spec.append((f"detr.input_proj.{lvl}.0.weight", shape, "matrix"))
        spec.append((f"detr.input_proj.{lvl}.0.bias", (d,), "bias"))
        gpv._norm(spec, f"detr.input_proj.{lvl}.1", d)
    spec.append(("detr.query_embed.weight", (int(detr["num_queries"]), 2 * d),
                 "unit"))
    t = "detr.transformer"
    spec.append((f"{t}.level_embed", (levels, d), "unit"))
    for i in range(int(detr["num_encoder_layers"])):
        b = f"{t}.encoder.layers.{i}"
        _msdeform_spec(spec, f"{b}.self_attn", d, heads, levels, enc_points)
        gpv._norm(spec, f"{b}.norm1", d)
        gpv._linear(spec, f"{b}.linear1", ff, d)
        gpv._linear(spec, f"{b}.linear2", d, ff)
        gpv._norm(spec, f"{b}.norm2", d)
    for i in range(int(detr["num_decoder_layers"])):
        b = f"{t}.decoder.layers.{i}"
        _msdeform_spec(spec, f"{b}.cross_attn", d, heads, levels, dec_points)
        gpv._norm(spec, f"{b}.norm1", d)
        gpv._mha(spec, f"{b}.self_attn", d)
        gpv._norm(spec, f"{b}.norm2", d)
        gpv._linear(spec, f"{b}.linear1", ff, d)
        gpv._linear(spec, f"{b}.linear2", d, ff)
        gpv._norm(spec, f"{b}.norm3", d)
    gpv._linear(spec, f"{t}.reference_points", 2, d)
    return base[:cut] + spec + base[cut:]


@torch.no_grad()
def make_weights(spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """`reference/gpv.py`'s draw, a "unit" weight drawn as an "embed" one
    (N(0, 0.1^2)) and scaled to N(0, 1)."""
    W = gpv.make_weights([(n, s, "embed" if k == "unit" else k)
                          for n, s, k in spec], seed, device)
    for n, _, k in spec:
        if k == "unit":
            W[n].mul_(1.0 / gpv.STD["embed"])
    return W


# ------------------------------------------------------------------ layers

def resnet_stages(P, W, x, layers) -> List[torch.Tensor]:
    """(B,3,H,W) -> the outputs of layer1-layer4 (C2-C5), torchvision's
    ResNet with the stride on the 3x3 conv (`reference/gpv.py`'s `resnet`,
    every stage's output kept)."""
    body = "detr.backbone.0.body"
    x = F.relu(frozen_bn(P.conv(x, W[f"{body}.conv1.weight"], stride=2,
                                padding=3), W, f"{body}.bn1"))
    x = F.max_pool2d(x, 3, 2, 1)
    outs = []
    for s, n in enumerate(layers):
        for b in range(n):
            base = f"{body}.layer{s + 1}.{b}"
            st = (1 if s == 0 else 2) if b == 0 else 1
            idn = x
            if b == 0:
                idn = frozen_bn(P.conv(x, W[f"{base}.downsample.0.weight"],
                                       stride=st), W, f"{base}.downsample.1")
            y = F.relu(frozen_bn(P.conv(x, W[f"{base}.conv1.weight"]), W,
                                 f"{base}.bn1"))
            y = F.relu(frozen_bn(P.conv(y, W[f"{base}.conv2.weight"],
                                        stride=st, padding=1), W,
                                 f"{base}.bn2"))
            y = frozen_bn(P.conv(y, W[f"{base}.conv3.weight"]), W,
                          f"{base}.bn3")
            x = F.relu(y + idn)
        outs.append(x)
    return outs


def group_norm(x, W, name, groups: int = 32, eps: float = 1e-5):
    return F.group_norm(x, groups, W[f"{name}.weight"], W[f"{name}.bias"],
                        eps)


def sine_pos(valid, feats: int):
    """Deformable DETR's PositionEmbeddingSine (normalize=True, scale 2 pi,
    the counts less 0.5) over a (B, h, w) validity mask -> (B, h*w,
    2*feats), y features first."""
    B, h, w = valid.shape
    not_mask = valid.float()
    y = not_mask.cumsum(1)
    x = not_mask.cumsum(2)
    eps, scale = 1e-6, 2 * math.pi
    y = (y - 0.5) / (y[:, -1:, :] + eps) * scale
    x = (x - 0.5) / (x[:, :, -1:] + eps) * scale
    dim_t = torch.arange(feats, dtype=torch.float32, device=valid.device)
    dim_t = 10000.0 ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                        / feats)
    px, py = x[..., None] / dim_t, y[..., None] / dim_t
    px = torch.stack((px[..., 0::2].sin(), px[..., 1::2].cos()),
                     dim=4).flatten(3)
    py = torch.stack((py[..., 0::2].sin(), py[..., 1::2].cos()),
                     dim=4).flatten(3)
    return torch.cat((py, px), dim=3).reshape(B, h * w, 2 * feats)


def ms_deform_sample(P: Precision, value, shapes, loc, attn):
    """`ms_deform_attn_core_pytorch`: value (B, S, H, Dh), loc (B, Q, H, L,
    Pt, 2) in [0, 1], attn (B, Q, H, L, Pt) -> (B, Q, H*Dh); the value
    and the attention weights rounded by `P`."""
    B, S, H, Dh = value.shape
    _, Q, _, L, Pt, _ = loc.shape
    value, attn = P.q(value), P.q(attn)
    levels = value.split([h * w for h, w in shapes], dim=1)
    grids = 2 * loc - 1
    sampled = []
    for lvl, (h, w) in enumerate(shapes):
        v = levels[lvl].flatten(2).transpose(1, 2).reshape(B * H, Dh, h, w)
        g = grids[:, :, :, lvl].transpose(1, 2).flatten(0, 1)
        sampled.append(F.grid_sample(v, g, mode="bilinear",
                                     padding_mode="zeros",
                                     align_corners=False))
    a = attn.transpose(1, 2).reshape(B * H, 1, Q, L * Pt)
    out = (torch.stack(sampled, dim=-2).flatten(-2) * a).sum(-1)
    return out.view(B, H * Dh, Q).transpose(1, 2)


def msdeform_attn(P, W, name, query, ref, value_in, shapes, value_valid,
                  heads: int, levels: int, points: int):
    """MSDeformAttn: query (B, Q, d), ref (B, Q, L, 2), value_in (B, S, d),
    value_valid (B, S) bool."""
    B, Q, d = query.shape
    value = dense(P, W, f"{name}.value_proj", value_in)
    value = value.masked_fill(~value_valid[..., None], 0.0)
    value = value.view(B, -1, heads, d // heads)
    off = dense(P, W, f"{name}.sampling_offsets", query).view(
        B, Q, heads, levels, points, 2)
    attn = dense(P, W, f"{name}.attention_weights", query).view(
        B, Q, heads, levels * points).softmax(-1).view(
            B, Q, heads, levels, points)
    norm = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32,
                        device=query.device)
    loc = ref[:, :, None, :, None, :] + off / norm[None, None, None, :,
                                                    None, :]
    return dense(P, W, f"{name}.output_proj",
                 ms_deform_sample(P, value, shapes, loc, attn))


def valid_ratio(valid):
    """(B, h, w) -> (B, 2): the valid share of the columns and the rows
    (`get_valid_ratio`)."""
    _, h, w = valid.shape
    vh = valid[:, :, 0].sum(1).float() / h
    vw = valid[:, 0, :].sum(1).float() / w
    return torch.stack([vw, vh], -1)


def encoder_reference_points(shapes, ratios):
    """`DeformableTransformerEncoder.get_reference_points`."""
    refs = []
    for lvl, (h, w) in enumerate(shapes):
        ry, rx = torch.meshgrid(
            torch.linspace(0.5, h - 0.5, h, dtype=torch.float32,
                           device=ratios.device),
            torch.linspace(0.5, w - 0.5, w, dtype=torch.float32,
                           device=ratios.device), indexing="ij")
        ry = ry.reshape(-1)[None] / (ratios[:, None, lvl, 1] * h)
        rx = rx.reshape(-1)[None] / (ratios[:, None, lvl, 0] * w)
        refs.append(torch.stack((rx, ry), -1))
    return torch.cat(refs, 1)[:, :, None] * ratios[:, None]


def inverse_sigmoid(x, eps=1e-5):
    x = x.clamp(min=0, max=1)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


def _encoder(P, W, model, src, pos, ref, shapes, valid):
    detr = model["detr"]
    heads = int(detr["nheads"])
    levels, points, _ = deform_dims(model)
    mem = src
    for i in range(int(detr["num_encoder_layers"])):
        b = f"detr.transformer.encoder.layers.{i}"
        a = msdeform_attn(P, W, f"{b}.self_attn", mem + pos, ref, mem, shapes,
                          valid, heads, levels, points)
        mem = layer_norm(mem + a, W, f"{b}.norm1")
        mem = layer_norm(mem + gpv.ffn(P, W, b, mem), W, f"{b}.norm2")
    return mem


def deformable_detr_forward(P, W, model, images, image_valid=None):
    """images (B,H,W,3) normalised fp32, image_valid (B,H,W) bool or None
    -> (class logits (B,Q,K+1), boxes (B,Q,4), detr_hs (B,Q,2048+d))."""
    detr = model["detr"]
    d, heads = int(detr["hidden_dim"]), int(detr["nheads"])
    levels, _, dec_points = deform_dims(model)
    B, H, Wd, _ = images.shape
    if image_valid is None:
        image_valid = torch.ones(B, H, Wd, dtype=torch.bool,
                                 device=images.device)
    maps = resnet_stages(P, W, images.permute(0, 3, 1, 2),
                         gpv.backbone_layers(detr))[1:]
    srcs = []
    for lvl in range(levels):
        name = f"detr.input_proj.{lvl}"
        if lvl < len(maps):
            x = P.conv(maps[lvl], W[f"{name}.0.weight"], W[f"{name}.0.bias"])
        else:
            x = P.conv(maps[-1] if lvl == len(maps) else srcs[-1],
                       W[f"{name}.0.weight"], W[f"{name}.0.bias"], stride=2,
                       padding=1)
        srcs.append(group_norm(x, W, f"{name}.1"))
    shapes = [tuple(s.shape[-2:]) for s in srcs]
    masks = [F.interpolate(image_valid[None].float(), size=s.shape[-2:])
             .to(torch.bool)[0] for s in srcs]
    src = torch.cat([s.flatten(2).transpose(1, 2) for s in srcs], 1)
    pos = torch.cat([sine_pos(m, d // 2)
                     + W["detr.transformer.level_embed"][lvl]
                     for lvl, m in enumerate(masks)], 1)
    valid = torch.cat([m.flatten(1) for m in masks], 1)
    ratios = torch.stack([valid_ratio(m) for m in masks], 1)
    ref = encoder_reference_points(shapes, ratios)
    mem = torch.cat([
        _encoder(P, W, model, src[i:i + ENCODER_BLOCK],
                 pos[i:i + ENCODER_BLOCK], ref[i:i + ENCODER_BLOCK], shapes,
                 valid[i:i + ENCODER_BLOCK])
        for i in range(0, B, ENCODER_BLOCK)])
    qpos, tgt = W["detr.query_embed.weight"].split(d, dim=1)
    qpos = qpos[None].expand(B, -1, -1)
    tgt = tgt[None].expand(B, -1, -1)
    ref_q = dense(P, W, "detr.transformer.reference_points", qpos).sigmoid()
    ref_in = ref_q[:, :, None] * ratios[:, None]
    for i in range(int(detr["num_decoder_layers"])):
        b = f"detr.transformer.decoder.layers.{i}"
        q = tgt + qpos
        tgt = layer_norm(tgt + gpv.mha(P, W, f"{b}.self_attn", q, q, tgt,
                                       heads), W, f"{b}.norm2")
        a = msdeform_attn(P, W, f"{b}.cross_attn", tgt + qpos, ref_in, mem,
                          shapes, valid, heads, levels, dec_points)
        tgt = layer_norm(tgt + a, W, f"{b}.norm1")
        tgt = layer_norm(tgt + gpv.ffn(P, W, b, tgt), W, f"{b}.norm3")
    hs = tgt
    logits = dense(P, W, "detr.class_embed", hs)
    x = hs
    for i in range(3):
        x = dense(P, W, f"detr.bbox_embed.layers.{i}", x)
        if i < 2:
            x = F.relu(x)
    boxes = (x + F.pad(inverse_sigmoid(ref_q), (0, 2))).sigmoid()
    roi = roi_align_mean(maps[-1], boxes.detach())
    roi = F.layer_norm(roi, roi.shape[-1:], eps=1e-5)
    return logits, boxes, torch.cat([roi, hs], dim=-1)


def encode(P, W, model, images_uint8, query_ids, query_valid,
           image_valid=None):
    """uint8 (B,H,W,3) images and (B,T) query ids -> {memory (B,Q+T,D),
    mem_valid, logits (B,Q,K+1), relevance (B,Q), boxes (B,Q,4)}, every
    output in query order (unsorted), as `reference/gpv.py`'s `encode`."""
    x = images_uint8.float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    logits, boxes, detr_hs = deformable_detr_forward(
        P, W, model, (x - mean) / std, image_valid)
    vl = dense(P, W, "detr_joiner", detr_hs)
    lv = dense(P, W, "bert_joiner",
               bert_forward(P, W, model, query_ids, query_valid))
    for i in range(int(model["co_att"]["num_layers"])):
        lv, vl = coattention_layer(P, W, f"co_att_transformer.{i}",
                                   model["co_att"], lv, vl, query_valid)
    rel_logits = logits + dense(P, W, "relevance_predictor", vl)
    prob = rel_logits.softmax(-1)
    vl = vl + P.matmul(prob, W["relevance_tokens"])
    memory = torch.cat([vl, lv], dim=1)
    B, Q = vl.shape[:2]
    mem_valid = torch.cat([torch.ones(B, Q, dtype=torch.bool,
                                      device=memory.device), query_valid], 1)
    return {"memory": memory, "mem_valid": mem_valid, "logits": rel_logits,
            "relevance": prob[..., 0], "boxes": boxes}
