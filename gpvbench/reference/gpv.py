"""GPV-1 written out in plain PyTorch: the yardstick the benchmark holds the
program's outputs against.

It follows the published model (allenai/gpv-1 `exp/gpv/models/gpv.py`,
facebookresearch/detr, HF `bert-base-uncased`, ViLBERT's connection layer,
torch's `nn.TransformerDecoder`) from the configuration's `model` node and
a dict of fp32 weights under the reference state dict's names. It imports
nothing of the program and keeps no state: no folded BatchNorm (the frozen
statistics are applied as they are), no KV cache (the answer decoder runs
teacher-forced over the whole answer), no batching tricks, no kernels.

Every product of two tensors (linear layers, convolutions, the attention
products) goes through one `Precision`. `Precision("float32")` computes in
fp32 with TF32 off, the yardstick. `Precision("float8")` rounds both
operands of every product to float8 e4m3 (one scale a tensor, from its
largest magnitude, as fp8 training scales) and accumulates in fp32: the
benchmark's control, the next precision below the bfloat16 that the
configurations state. `Precision("bfloat16")` rounds both operands to
bfloat16 and accumulates in fp32: the scale of the rounding a bf16 program
meets, against which served boxes are judged (`judge.py`).

`param_spec(model_cfg, vocab_size)` names every weight with its shape and
its kind of initial value; `make_weights` draws them on a device from a
seed in a few large calls.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

NEG = -1e9
BACKBONES = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}
FP8_MAX = 448.0  # largest finite float8 e4m3 value


class Precision:
    """The arithmetic of every product: "float32", "bfloat16" or "float8"
    (module docstring)."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "bfloat16", "float8"):
            raise ValueError(f"precision {name!r}: float32, bfloat16 or "
                             "float8")
        self.name = name

    def q(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.name == "float32":
            return x
        if self.name == "bfloat16":
            return x.to(torch.bfloat16).float()
        scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), None if b is None else b.float())

    def conv(self, x, w, b=None, stride=1, padding=0, dilation=1):
        return F.conv2d(self.q(x), self.q(w), None if b is None else b.float(),
                        stride, padding, dilation)

    def matmul(self, a, b):
        return torch.matmul(self.q(a), self.q(b))


# ----------------------------------------------------------------- weights

def _linear(spec, name, n_out, n_in, bias=True):
    spec.append((f"{name}.weight", (n_out, n_in), "matrix"))
    if bias:
        spec.append((f"{name}.bias", (n_out,), "bias"))


def _norm(spec, name, dim):
    spec.append((f"{name}.weight", (dim,), "one"))
    spec.append((f"{name}.bias", (dim,), "zero"))


def _bn(spec, name, dim):
    for leaf, kind in (("weight", "bn_scale"), ("bias", "bn_shift"),
                       ("running_mean", "bn_shift"),
                       ("running_var", "bn_scale")):
        spec.append((f"{name}.{leaf}", (dim,), kind))


def _mha(spec, name, dim):
    spec.append((f"{name}.in_proj_weight", (3 * dim, dim), "matrix"))
    spec.append((f"{name}.in_proj_bias", (3 * dim,), "bias"))
    _linear(spec, f"{name}.out_proj", dim, dim)


def backbone_layers(detr) -> Tuple[int, ...]:
    if detr.get("backbone_layers"):
        return tuple(int(x) for x in detr["backbone_layers"])
    return BACKBONES[detr.get("backbone", "resnet50")]


def bert_dims(model: dict) -> Tuple[int, int, int, int, int]:
    """(hidden, layers, heads, vocabulary, positions) of BERT: the
    `model.bert` node where the configuration gives one, else BERT-base."""
    b = model.get("bert") or {}
    return (int(b.get("hidden", 768)), int(b.get("num_layers", 12)),
            int(b.get("heads", 12)), int(b.get("vocab_size", 30522)),
            int(b.get("max_len", 512)))


def param_spec(model: dict, vocab_size: int) -> List[tuple]:
    """[(name, shape, kind)] of every weight, in the reference state dict's
    names. Kinds: matrix N(0, 1/fan_in), bias N(0, 0.02^2), embed
    N(0, 0.1^2), bn_scale U(0.5, 1.5), bn_shift N(0, 0.1^2), one, zero."""
    spec: List[tuple] = []
    detr, D = model["detr"], int(model["hidden_dim"])
    d = int(detr["hidden_dim"])
    body = "detr.backbone.0.body"
    spec.append((f"{body}.conv1.weight", (64, 3, 7, 7), "matrix"))
    _bn(spec, f"{body}.bn1", 64)
    in_ch = 64
    for s, (n, planes) in enumerate(zip(backbone_layers(detr),
                                        (64, 128, 256, 512))):
        for b in range(n):
            base = f"{body}.layer{s + 1}.{b}"
            cin = in_ch if b == 0 else 4 * planes
            for i, shape in ((1, (planes, cin, 1, 1)),
                             (2, (planes, planes, 3, 3)),
                             (3, (4 * planes, planes, 1, 1))):
                spec.append((f"{base}.conv{i}.weight", shape, "matrix"))
                _bn(spec, f"{base}.bn{i}", shape[0])
            if b == 0:
                spec.append((f"{base}.downsample.0.weight",
                             (4 * planes, cin, 1, 1), "matrix"))
                _bn(spec, f"{base}.downsample.1", 4 * planes)
        in_ch = 4 * planes
    spec.append(("detr.input_proj.weight", (d, 2048, 1, 1), "matrix"))
    spec.append(("detr.input_proj.bias", (d,), "bias"))
    spec.append(("detr.query_embed.weight", (int(detr["num_queries"]), d),
                 "embed"))
    ff = int(detr["dim_feedforward"])
    for kind, n in (("encoder", int(detr["num_encoder_layers"])),
                    ("decoder", int(detr["num_decoder_layers"]))):
        for i in range(n):
            base = f"detr.transformer.{kind}.layers.{i}"
            _mha(spec, f"{base}.self_attn", d)
            if kind == "decoder":
                _mha(spec, f"{base}.multihead_attn", d)
            _linear(spec, f"{base}.linear1", ff, d)
            _linear(spec, f"{base}.linear2", d, ff)
            for k in range(1, 3 if kind == "encoder" else 4):
                _norm(spec, f"{base}.norm{k}", d)
    _norm(spec, "detr.transformer.decoder.norm", d)
    _linear(spec, "detr.class_embed", int(detr["num_classes"]) + 1, d)
    for i, (o, n) in enumerate(((d, d), (d, d), (4, d))):
        _linear(spec, f"detr.bbox_embed.layers.{i}", o, n)
    _linear(spec, "detr_joiner", D, d + 2048)
    bert = "bert.model"
    bh, bl, _, bv, bmax = bert_dims(model)
    spec.append((f"{bert}.embeddings.word_embeddings.weight", (bv, bh),
                 "embed"))
    spec.append((f"{bert}.embeddings.position_embeddings.weight", (bmax, bh),
                 "embed"))
    spec.append((f"{bert}.embeddings.token_type_embeddings.weight", (2, bh),
                 "embed"))
    _norm(spec, f"{bert}.embeddings.LayerNorm", bh)
    for i in range(bl):
        base = f"{bert}.encoder.layer.{i}"
        for p in ("query", "key", "value"):
            _linear(spec, f"{base}.attention.self.{p}", bh, bh)
        _linear(spec, f"{base}.attention.output.dense", bh, bh)
        _norm(spec, f"{base}.attention.output.LayerNorm", bh)
        _linear(spec, f"{base}.intermediate.dense", 4 * bh, bh)
        _linear(spec, f"{base}.output.dense", bh, 4 * bh)
        _norm(spec, f"{base}.output.LayerNorm", bh)
    _linear(spec, "bert_joiner", D, bh)
    co = model["co_att"]
    for i in range(int(co["num_layers"])):
        base = f"co_att_transformer.{i}"
        for p in ("query", "key", "value"):
            for s in ("1", "2"):
                _linear(spec, f"{base}.biattention.{p}{s}", D, D)
        for s in ("1", "2"):
            _linear(spec, f"{base}.biOutput.dense{s}", D, D)
            _norm(spec, f"{base}.biOutput.LayerNorm{s}", D)
        for tag, width in (("v", int(co["v_intermediate_size"])),
                           ("t", int(co["intermediate_size"]))):
            _linear(spec, f"{base}.{tag}_intermediate.dense", width, D)
            _linear(spec, f"{base}.{tag}_output.dense", D, width)
            _norm(spec, f"{base}.{tag}_output.LayerNorm", D)
    _linear(spec, "relevance_predictor", int(detr["num_classes"]) + 1, D)
    for i in range(int(model["text_decoder"]["num_layers"])):
        base = f"text_decoder.layers.{i}"
        _mha(spec, f"{base}.self_attn", D)
        _mha(spec, f"{base}.multihead_attn", D)
        _linear(spec, f"{base}.linear1", 2048, D)
        _linear(spec, f"{base}.linear2", D, 2048)
        for k in (1, 2, 3):
            _norm(spec, f"{base}.norm{k}", D)
    spec.append(("answer_head.vocab_embed", (vocab_size, D), "embed"))
    _linear(spec, "answer_head.classifier_transform", D, D)
    _linear(spec, "answer_input_embedings.transform", D, D)
    for n, shape in (("vision_token", (D,)), ("lang_token", (D,)),
                     ("relevance_tokens", (2, D))):
        spec.append((n, shape, "embed"))
    return spec


STD = {"bias": 0.02, "embed": 0.1, "bn_shift": 0.1}


@torch.no_grad()
def make_weights(spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """fp32 weights of `spec` from `seed`: one normal draw and one uniform
    draw on `device` for all of them, each weight a view of its slice."""
    g = torch.Generator(device=device).manual_seed(seed)
    normal = [(n, s, k) for n, s, k in spec
              if k in ("matrix", "bias", "embed", "bn_shift")]
    uniform = [(n, s, k) for n, s, k in spec if k == "bn_scale"]
    out: Dict[str, torch.Tensor] = {}
    for group, draw in ((normal, torch.randn), (uniform, torch.rand)):
        total = sum(math.prod(s) for _, s, _ in group)
        buf = draw(total, generator=g, device=device)
        off = 0
        for name, shape, kind in group:
            n = math.prod(shape)
            t = buf[off:off + n].view(shape)
            off += n
            if kind == "matrix":
                t.mul_(1.0 / math.sqrt(math.prod(shape[1:])))
            elif kind == "bn_scale":
                t.add_(0.5)
            else:
                t.mul_(STD[kind])
            out[name] = t
    for name, shape, kind in spec:
        if kind in ("one", "zero"):
            out[name] = (torch.ones if kind == "one" else torch.zeros)(
                shape, device=device)
    return out


# ------------------------------------------------------------------ layers

def layer_norm(x, W, name, eps=1e-5):
    return F.layer_norm(x, x.shape[-1:], W[f"{name}.weight"],
                        W[f"{name}.bias"], eps)


def attention(P: Precision, q, k, v, heads: int, key_valid=None,
              causal: bool = False):
    """q (B,Tq,D), k/v (B,Tk,D), already projected -> (B,Tq,D): softmax of
    the scaled products, invalid keys (and future keys with `causal`) at
    -1e9, in fp32."""
    B, Tq, Dm = q.shape
    Tk, dh = k.shape[1], Dm // heads
    qh = q.view(B, Tq, heads, dh).transpose(1, 2)
    kh = k.view(B, Tk, heads, dh).transpose(1, 2)
    vh = v.view(B, Tk, heads, dh).transpose(1, 2)
    s = P.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(dh)
    if key_valid is not None:
        s = s + torch.where(key_valid, 0.0, NEG)[:, None, None, :]
    if causal:
        s = s + torch.full((Tq, Tk), NEG, device=s.device).triu(1)
    return P.matmul(s.softmax(-1), vh).transpose(1, 2).reshape(
        B, Tq, Dm)


def mha(P, W, name, q_in, k_in, v_in, heads, key_valid=None, causal=False):
    """torch's nn.MultiheadAttention with packed in_proj."""
    w, b = W[f"{name}.in_proj_weight"], W[f"{name}.in_proj_bias"]
    D = q_in.shape[-1]
    q = P.linear(q_in, w[:D], b[:D])
    k = P.linear(k_in, w[D:2 * D], b[D:2 * D])
    v = P.linear(v_in, w[2 * D:], b[2 * D:])
    o = attention(P, q, k, v, heads, key_valid, causal)
    return P.linear(o, W[f"{name}.out_proj.weight"],
                    W[f"{name}.out_proj.bias"])


def dense(P, W, name, x):
    return P.linear(x, W[f"{name}.weight"], W[f"{name}.bias"])


# ---------------------------------------------------------------- ResNet

def frozen_bn(x, W, name, eps=1e-5):
    scale = W[f"{name}.weight"] / torch.sqrt(W[f"{name}.running_var"] + eps)
    shift = W[f"{name}.bias"] - W[f"{name}.running_mean"] * scale
    return x * scale[:, None, None] + shift[:, None, None]


def resnet(P, W, x, layers, dilate_c5: bool):
    """(B,3,H,W) -> C5 (B,2048,h,w); torchvision's ResNet, stride on the
    3x3 conv, layer4 dilated (stride 1, dilation 2) for DC5."""
    body = "detr.backbone.0.body"
    x = F.relu(frozen_bn(P.conv(x, W[f"{body}.conv1.weight"], stride=2,
                                padding=3), W, f"{body}.bn1"))
    x = F.max_pool2d(x, 3, 2, 1)
    for s, n in enumerate(layers):
        stride, dil = (1 if s == 0 else 2), 1
        if dilate_c5 and s == 3:
            stride, dil = 1, 2
        for b in range(n):
            base = f"{body}.layer{s + 1}.{b}"
            st = stride if b == 0 else 1
            idn = x
            if b == 0:
                idn = frozen_bn(P.conv(x, W[f"{base}.downsample.0.weight"],
                                       stride=st),
                                W, f"{base}.downsample.1")
            y = F.relu(frozen_bn(P.conv(x, W[f"{base}.conv1.weight"]), W,
                                 f"{base}.bn1"))
            y = F.relu(frozen_bn(P.conv(y, W[f"{base}.conv2.weight"],
                                        stride=st, padding=dil,
                                        dilation=dil), W, f"{base}.bn2"))
            y = frozen_bn(P.conv(y, W[f"{base}.conv3.weight"]), W,
                          f"{base}.bn3")
            x = F.relu(y + idn)
    return x


# ------------------------------------------------------------------ DETR

def sine_pos(B, h, w, feats: int, device):
    """DETR's PositionEmbeddingSine (normalize=True, scale 2 pi) over an
    all-valid (h, w) map -> (B, h*w, 2*feats), y features first."""
    ones = torch.ones(B, h, w, device=device)
    y = ones.cumsum(1)
    x = ones.cumsum(2)
    eps, scale = 1e-6, 2 * math.pi
    y = y / (y[:, -1:, :] + eps) * scale
    x = x / (x[:, :, -1:] + eps) * scale
    dim_t = torch.arange(feats, dtype=torch.float32, device=device)
    dim_t = 10000.0 ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                        / feats)
    px, py = x[..., None] / dim_t, y[..., None] / dim_t
    px = torch.stack((px[..., 0::2].sin(), px[..., 1::2].cos()),
                     dim=4).flatten(3)
    py = torch.stack((py[..., 0::2].sin(), py[..., 1::2].cos()),
                     dim=4).flatten(3)
    return torch.cat((py, px), dim=3).reshape(B, h * w, 2 * feats)


def roi_align_mean(feats, boxes, pooled: int = 7, max_grid: int = 8):
    """torchvision `roi_align(output_size=7, aligned=True,
    sampling_ratio=-1)` then the mean over the 7x7 bins, the sampling grid
    capped at `max_grid` a side as GPV's RoI head runs it: every sample
    point's four bilinear corners are scattered into a weight over the
    feature map, and the weights times the map give each RoI's mean.
    feats (B,C,h,w) fp32, boxes (B,N,4) normalised cxcywh -> (B,N,C)."""
    B, C, H, Wd = feats.shape
    N = boxes.shape[1]
    cx, cy, bw, bh = boxes.float().unbind(-1)
    x0, y0 = Wd * (cx - bw / 2) - 0.5, H * (cy - bh / 2) - 0.5
    ext = {"y": (y0, H * bh, H), "x": (x0, Wd * bw, Wd)}
    axes = {}
    for ax, (start, length, size) in ext.items():
        grid = torch.ceil(length / pooled).clamp(1, max_grid)    # (B,N)
        p = torch.arange(pooled, device=feats.device, dtype=torch.float32)
        g = torch.arange(max_grid, device=feats.device, dtype=torch.float32)
        binsz = (length / pooled)[..., None, None]
        c = (start[..., None, None] + p[:, None] * binsz
             + (g[None, :] + 0.5) * binsz / grid[..., None, None])
        on = (g[None, :] < grid[..., None, None]) & (c >= -1) & (c <= size)
        c = c.clamp(min=0)
        lo = c.floor().long()
        top = lo >= size - 1
        lo = torch.where(top, size - 1, lo)
        hi = torch.where(top, size - 1, lo + 1)
        c = torch.where(top, lo.float(), c)
        frac = c - lo
        axes[ax] = (lo.flatten(2), hi.flatten(2), frac.flatten(2),
                    on.flatten(2), grid)
    ylo, yhi, fy, ony, gy = axes["y"]
    xlo, xhi, fx, onx, gx = axes["x"]
    wmap = torch.zeros(B, N, H * Wd, device=feats.device)
    for yi, wy in ((ylo, 1 - fy), (yhi, fy)):
        for xi, wx in ((xlo, 1 - fx), (xhi, fx)):
            w = (wy * ony)[..., :, None] * (wx * onx)[..., None, :]
            idx = yi[..., :, None] * Wd + xi[..., None, :]
            wmap.scatter_add_(2, idx.flatten(2), w.flatten(2))
    wmap = wmap / (gy * gx * pooled * pooled)[..., None]
    return torch.bmm(wmap, feats.flatten(2).transpose(1, 2))


def ffn(P, W, base, x):
    return dense(P, W, f"{base}.linear2",
                 F.relu(dense(P, W, f"{base}.linear1", x)))


def detr_forward(P, W, model, images):
    """images (B,H,W,3) normalised fp32 -> (class logits (B,Q,K+1), boxes
    (B,Q,4), detr_hs (B,Q,2048+d))."""
    detr = model["detr"]
    d, heads = int(detr["hidden_dim"]), int(detr["nheads"])
    feats = resnet(P, W, images.permute(0, 3, 1, 2), backbone_layers(detr),
                   bool(detr["dilation"]))
    B, _, h, w = feats.shape
    src = P.conv(feats, W["detr.input_proj.weight"],
                 W["detr.input_proj.bias"]).flatten(2).transpose(1, 2)
    pos = sine_pos(B, h, w, d // 2, images.device)
    mem = src
    for i in range(int(detr["num_encoder_layers"])):
        base = f"detr.transformer.encoder.layers.{i}"
        q = mem + pos
        mem = layer_norm(mem + mha(P, W, f"{base}.self_attn", q, q, mem,
                                   heads), W, f"{base}.norm1")
        mem = layer_norm(mem + ffn(P, W, base, mem), W, f"{base}.norm2")
    qpos = W["detr.query_embed.weight"][None].expand(B, -1, -1)
    tgt = torch.zeros_like(qpos)
    for i in range(int(detr["num_decoder_layers"])):
        base = f"detr.transformer.decoder.layers.{i}"
        q = tgt + qpos
        tgt = layer_norm(tgt + mha(P, W, f"{base}.self_attn", q, q, tgt,
                                   heads), W, f"{base}.norm1")
        tgt = layer_norm(tgt + mha(P, W, f"{base}.multihead_attn",
                                   tgt + qpos, mem + pos, mem, heads), W,
                         f"{base}.norm2")
        tgt = layer_norm(tgt + ffn(P, W, base, tgt), W, f"{base}.norm3")
    hs = layer_norm(tgt, W, "detr.transformer.decoder.norm")
    logits = dense(P, W, "detr.class_embed", hs)
    x = hs
    for i in range(3):
        x = dense(P, W, f"detr.bbox_embed.layers.{i}", x)
        if i < 2:
            x = F.relu(x)
    boxes = x.sigmoid()
    # torchvision's roi_align takes no gradient into the boxes
    roi = roi_align_mean(feats, boxes.detach())
    roi = F.layer_norm(roi, roi.shape[-1:], eps=1e-5)
    return logits, boxes, torch.cat([roi, hs], dim=-1)


# ------------------------------------------------------------ BERT, fusion

def bert_forward(P, W, model, ids, valid):
    """HF BERT's last hidden states (post-norm, GELU-erf, eps 1e-12)."""
    _, layers, heads, _, _ = bert_dims(model)
    e = "bert.model.embeddings"
    T = ids.shape[1]
    x = (W[f"{e}.word_embeddings.weight"][ids]
         + W[f"{e}.position_embeddings.weight"][:T][None]
         + W[f"{e}.token_type_embeddings.weight"][0])
    x = layer_norm(x, W, f"{e}.LayerNorm", 1e-12)
    for i in range(layers):
        base = f"bert.model.encoder.layer.{i}"
        a = f"{base}.attention"
        ctx = attention(P, dense(P, W, f"{a}.self.query", x),
                        dense(P, W, f"{a}.self.key", x),
                        dense(P, W, f"{a}.self.value", x), heads, valid)
        x = layer_norm(x + dense(P, W, f"{a}.output.dense", ctx), W,
                       f"{a}.output.LayerNorm", 1e-12)
        hmid = F.gelu(dense(P, W, f"{base}.intermediate.dense", x))
        x = layer_norm(x + dense(P, W, f"{base}.output.dense", hmid), W,
                       f"{base}.output.LayerNorm", 1e-12)
    return x


ACTS = {"gelu": F.gelu, "relu": F.relu, "swish": F.silu}


def coattention_layer(P, W, base, co, x1, x2, valid1):
    """ViLBERT's connection layer as GPV calls it: stream 1 is the text
    (masked by `valid1`), stream 2 the vision queries. Stream 1 runs
    through the `v_*` FFN and stream 2 through the `t_*` one."""
    heads = int(co["bi_num_attention_heads"])
    b = f"{base}.biattention"
    q1, k1, v1 = (dense(P, W, f"{b}.{p}1", x1)
                  for p in ("query", "key", "value"))
    q2, k2, v2 = (dense(P, W, f"{b}.{p}2", x2)
                  for p in ("query", "key", "value"))
    ctx1 = attention(P, q2, k1, v1, heads, valid1)   # vision reads text
    ctx2 = attention(P, q1, k2, v2, heads, None)     # text reads vision
    o = f"{base}.biOutput"
    a1 = layer_norm(x1 + dense(P, W, f"{o}.dense1", ctx2), W,
                    f"{o}.LayerNorm1", 1e-12)
    a2 = layer_norm(x2 + dense(P, W, f"{o}.dense2", ctx1), W,
                    f"{o}.LayerNorm2", 1e-12)
    act1, act2 = ACTS[co["v_hidden_act"]], ACTS[co["hidden_act"]]
    h1 = dense(P, W, f"{base}.v_output.dense",
               act1(dense(P, W, f"{base}.v_intermediate.dense", a1)))
    h2 = dense(P, W, f"{base}.t_output.dense",
               act2(dense(P, W, f"{base}.t_intermediate.dense", a2)))
    return (layer_norm(a1 + h1, W, f"{base}.v_output.LayerNorm", 1e-12),
            layer_norm(a2 + h2, W, f"{base}.t_output.LayerNorm", 1e-12))


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def encode(P, W, model, images_uint8, query_ids, query_valid):
    """uint8 (B,H,W,3) images and (B,T) query ids -> {memory (B,Q+T,D),
    mem_valid, logits (B,Q,K+1) (DETR's class logits plus relevance),
    relevance (B,Q) = P(relevant), boxes (B,Q,4)}, every output in query
    order (unsorted)."""
    x = images_uint8.float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    logits, boxes, detr_hs = detr_forward(P, W, model, (x - mean) / std)
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


def answer_logits(P, W, model, memory, mem_valid, tokens):
    """Teacher-forced answer decoder: tokens (B,S) (the first is
    `__cls__`) -> (B,S,V) fp32 logits of the next token at each place."""
    heads = int(model["text_decoder"]["nheads"])
    x = dense(P, W, "answer_input_embedings.transform",
              W["answer_head.vocab_embed"][tokens])
    for i in range(int(model["text_decoder"]["num_layers"])):
        base = f"text_decoder.layers.{i}"
        x = layer_norm(x + mha(P, W, f"{base}.self_attn", x, x, x, heads,
                               causal=True), W, f"{base}.norm1")
        x = layer_norm(x + mha(P, W, f"{base}.multihead_attn", x, memory,
                               memory, heads, mem_valid), W, f"{base}.norm2")
        x = layer_norm(x + ffn(P, W, base, x), W, f"{base}.norm3")
    classifier = dense(P, W, "answer_head.classifier_transform",
                       W["answer_head.vocab_embed"])
    return P.matmul(x, classifier.t())


def tokenize(words: List[str], queries: List[str], length: int):
    """A word-level BERT tokenizer over `words` (every query word is one of
    them): [CLS] words [SEP], padded with [PAD] to `length` -> (ids, valid)
    as int64 and bool tensors."""
    index = {w: i for i, w in enumerate(words)}
    ids = torch.full((len(queries), length), index["[PAD]"],
                     dtype=torch.long)
    valid = torch.zeros(len(queries), length, dtype=torch.bool)
    for r, q in enumerate(queries):
        toks = (["[CLS]"] + q.lower().replace("?", " ?").split()
                + ["[SEP]"])
        if len(toks) > length:
            raise ValueError(f"query of {len(toks)} tokens > {length}")
        ids[r, :len(toks)] = torch.tensor([index[t] for t in toks])
        valid[r, :len(toks)] = True
    return ids, valid
