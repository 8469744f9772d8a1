"""GPV-1's work counted from shapes: the model FLOPs of a greedy predict
call and of a train step, and the attention products such a call makes
with each product's bytes and operations.

FLOPs are twice the multiply-adds of every product the plain reference
(`reference/gpv.py`) computes: convolutions, linear layers, attention
products, the RoI-align contraction and the answer head; the answer
decoder runs teacher-forced over the answer's `steps` tokens, and the
answer classifier (vocabulary embedding times its transform) is made once
a call. This is what `torch.utils.flop_counter.FlopCounterMode` counts on
the reference, which the tests hold it to.

The launches are the program's: each fused attention call of `GPV.encode`
and of the KV-cached greedy decode (`steps` steps over a `max_text_len`
cache), as (name, b, tq, tk, heads, head_dim, masked keys, calls).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from ..flops import Launch, _mha, _mm, _out
from ..reference.gpv import backbone_layers, bert_dims


def resnet_flops(detr: dict, H: int, W: int, upto: int = 4
                 ) -> Tuple[float, int, int]:
    """(FLOPs of the trunk for one image, C5 height, C5 width); with
    `upto`, of the stem and the first `upto` stages only."""
    fl = 0.0
    h, w = _out(H, 7, 2, 3), _out(W, 7, 2, 3)
    fl += 2.0 * 64 * h * w * 3 * 49
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
    cin = 64
    for s, (n, planes) in enumerate(zip(backbone_layers(detr)[:upto],
                                        (64, 128, 256, 512))):
        stride, dil = (1 if s == 0 else 2), 1
        if detr.get("dilation") and s == 3:
            stride, dil = 1, 2
        for b in range(n):
            st = stride if b == 0 else 1
            c_in = cin if b == 0 else 4 * planes
            ho, wo = _out(h, 3, st, dil, dil), _out(w, 3, st, dil, dil)
            fl += 2.0 * planes * h * w * c_in              # conv1 1x1
            fl += 2.0 * planes * ho * wo * planes * 9      # conv2 3x3
            fl += 2.0 * 4 * planes * ho * wo * planes      # conv3 1x1
            if b == 0:
                fl += 2.0 * 4 * planes * ho * wo * c_in    # downsample
            h, w = ho, wo
        cin = 4 * planes
    return fl, h, w


def bert_flops(model: dict, L: int) -> float:
    """One L-token query through BERT and its joiner."""
    bh, bl = bert_dims(model)[:2]
    return (bl * (_mha(L, L, bh) + 2 * _mm(L, bh, 4 * bh))
            + _mm(L, bh, int(model["hidden_dim"])))


def encode_flops(model: dict, H: int, W: int, L: int,
                 bert: bool = True) -> float:
    """One image and one L-token query through `reference.gpv.encode`
    (without BERT and its joiner unless `bert`)."""
    detr = model["detr"]
    d, D = int(detr["hidden_dim"]), int(model["hidden_dim"])
    Q, ff = int(detr["num_queries"]), int(detr["dim_feedforward"])
    K1 = int(detr["num_classes"]) + 1
    fl, h, w = resnet_flops(detr, H, W)
    T = h * w
    fl += _mm(T, 2048, d)                                  # input_proj
    fl += int(detr["num_encoder_layers"]) * (_mha(T, T, d)
                                             + 2 * _mm(T, d, ff))
    fl += int(detr["num_decoder_layers"]) * (
        _mha(Q, Q, d) + _mha(Q, T, d) + 2 * _mm(Q, d, ff))
    fl += _mm(Q, d, K1) + 2 * _mm(Q, d, d) + _mm(Q, d, 4)  # heads
    fl += _mm(Q, T, 2048)                                  # RoI-align
    fl += _mm(Q, d + 2048, D)                              # detr_joiner
    if bert:
        fl += bert_flops(model, L)
    co = model["co_att"]
    for _ in range(int(co["num_layers"])):
        fl += 3 * _mm(L, D, D) + 3 * _mm(Q, D, D)          # q, k, v
        fl += 2 * _mm(Q, L, D) + 2 * _mm(L, Q, D)          # both ways
        fl += _mm(L, D, D) + _mm(Q, D, D)                  # biOutput
        fl += 2 * _mm(L, D, int(co["v_intermediate_size"]))
        fl += 2 * _mm(Q, D, int(co["intermediate_size"]))
    fl += _mm(Q, D, K1) + _mm(Q, K1, D)                    # relevance
    return fl


def decode_flops(model: dict, L: int, S: int, vocab: int) -> float:
    """One row's teacher-forced answer decoder over S tokens, without the
    classifier matrix (made once a call, `classifier_flops`)."""
    D, Q = int(model["hidden_dim"]), int(model["detr"]["num_queries"])
    M = Q + L
    fl = _mm(S, D, D)                                      # input transform
    fl += int(model["text_decoder"]["num_layers"]) * (
        _mha(S, S, D) + _mha(S, M, D) + 2 * _mm(S, D, 2048))
    return fl + _mm(S, D, vocab)                           # logits


def classifier_flops(model: dict, vocab: int) -> float:
    D = int(model["hidden_dim"])
    return _mm(vocab, D, D)


def predict_flops(model: dict, vocab: int, batch: int, H: int, W: int,
                  L: int, steps: int) -> float:
    """Model FLOPs of one greedy predict call of `batch` rows."""
    return (batch * (encode_flops(model, H, W, L)
                     + decode_flops(model, L, steps, vocab))
            + classifier_flops(model, vocab))


def train_flops(model: dict, vocab: int, batch: int, unique: int, H: int,
                W: int, L: int, S: int) -> float:
    """Model FLOPs of one train step of `batch` rows whose queries have
    `unique` distinct rows: the teacher-forced forward over S answer
    tokens, and twice the forward of every part the backward runs through
    (all but frozen BERT and the frozen stem and layer1)."""
    stem = resnet_flops(model["detr"], H, W, upto=1)[0]
    fwd = train_forward_flops(model, vocab, batch, unique, H, W, L, S)
    return fwd + 2 * (fwd - unique * bert_flops(model, L) - batch * stem)


def train_forward_flops(model: dict, vocab: int, batch: int, unique: int,
                        H: int, W: int, L: int, S: int) -> float:
    """The train step's forward: BERT over the `unique` query rows."""
    return (batch * (encode_flops(model, H, W, L, bert=False)
                     + decode_flops(model, L, S, vocab))
            + unique * bert_flops(model, L) + classifier_flops(model, vocab))


def predict_launches(model: dict, batch: int, H: int, W: int, L: int,
                     steps: int) -> List[Launch]:
    """Every attention product of one greedy predict call, as the model
    defines it (`calls` of each shape): the work whatever launches the
    program runs it in."""
    detr = model["detr"]
    d, heads = int(detr["hidden_dim"]), int(detr["nheads"])
    Q, D = int(detr["num_queries"]), int(model["hidden_dim"])
    _, h, w = resnet_flops(detr, H, W)
    T = h * w
    co_heads = int(model["co_att"]["bi_num_attention_heads"])
    td_heads = int(model["text_decoder"]["nheads"])
    n_td = int(model["text_decoder"]["num_layers"])
    S = int(model["max_text_len"])
    return [
        Launch("detr_encoder_self", batch, T, T, heads, d // heads, False,
               int(detr["num_encoder_layers"])),
        Launch("detr_decoder_self", batch, Q, Q, heads, d // heads, False,
               int(detr["num_decoder_layers"])),
        Launch("detr_decoder_cross", batch, Q, T, heads, d // heads, False,
               int(detr["num_decoder_layers"])),
        Launch("bert_self", batch, L, L, bert_dims(model)[2],
               bert_dims(model)[0] // bert_dims(model)[2], True,
               bert_dims(model)[1]),
        Launch("coattention", batch, Q, L, co_heads, D // co_heads, True,
               int(model["co_att"]["num_layers"]), both=True),
        Launch("decode_self", batch, 1, S, td_heads, D // td_heads, True,
               n_td * steps),
        Launch("decode_cross", batch, 1, Q + L, td_heads, D // td_heads,
               True, n_td * steps)]


def predict_work(model: dict, batch: int, H: int, W: int, L: int,
                 steps: int) -> Dict[str, List[Launch]]:
    """{kernel kind: work items} of one greedy predict call."""
    return {"attention": predict_launches(model, batch, H, W, L, steps)}
