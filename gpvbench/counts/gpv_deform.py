"""GPV-1 on Deformable DETR's work counted from shapes: the model FLOPs of a
greedy predict call, and each kernel kind's work items of such a call.

FLOPs are twice the multiply-adds of every product the plain reference
(`reference/gpv_deform.py`) computes (convolutions, linear layers, the
decoder's and GPV-1's attention products, the RoI-align contraction, the
answer head), plus the deformable sampling's own arithmetic
(`Sampling.flops`), which no product holds: what
`torch.utils.flop_counter.FlopCounterMode` counts on the reference, plus
the sampling. GPV-1's parts (BERT, co-attention, the decoder) are counted
as `counts/gpv.py` counts them, with this detector's queries.

Work items (`predict_work`):
- `attention`: the products the fused attention kernels K1 and K2 run:
  the decoder's self-attention over the queries, BERT, co-attention and
  the text decoder's steps over the queries and the query tokens;
- `msdeform`: one item a deformable layer (the encoder's, Q = S = the
  levels' rows; the decoder's, Q = the queries over S), each counting the
  operation's own inputs and outputs, whatever implements it
  (`Sampling`).

There is no training cell of this family: `train_flops` raises.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

from .. import family
from ..flops import Launch, _mha, _mm, _out
from ..reference.gpv_deform import TRUNK_CHANNELS, deform_dims

# GPV-1's counting, found through the family lookup
_gpv = family.counts({"family": "gpv"})
bert_flops, classifier_flops, resnet_flops = (
    _gpv.bert_flops, _gpv.classifier_flops, _gpv.resnet_flops)
bert_dims = family.reference({"family": "gpv"}).bert_dims

# a sample: four corners, each a multiply and an add a channel, and the
# attention weight's multiply and add
SAMPLE_FLOPS = 4 * 2 + 2


class Sampling(NamedTuple):
    """One deformable attention's sampling: `q` queries of `b` images, each
    of `heads` heads taking levels x points bilinear samples of a
    `dh`-wide head of `s` value rows."""
    name: str
    b: int
    q: int
    s: int
    heads: int
    dh: int
    levels: int
    points: int
    calls: int

    def bytes(self, elt: int = 2) -> float:
        """The value, the offsets and the logits read, the fp32 reference
        points read, the output written."""
        lp = self.levels * self.points
        return (self.b * self.s * self.heads * self.dh * elt
                + self.b * self.q * self.heads * lp * 2 * elt
                + self.b * self.q * self.heads * lp * elt
                + self.b * self.q * self.levels * 2 * 4
                + self.b * self.q * self.heads * self.dh * elt)

    def flops(self) -> float:
        return (float(self.b) * self.q * self.heads * self.levels
                * self.points * self.dh * SAMPLE_FLOPS)


def level_shapes(model: dict, H: int, W: int) -> List[Tuple[int, int]]:
    """The (h, w) of every level for an H x W image: C3-C5, then each
    further level a 3x3 stride-2 conv's output."""
    detr = model["detr"]
    shapes = []
    for upto in (2, 3, 4):
        _, h, w = resnet_flops(detr, H, W, upto=upto)
        shapes.append((h, w))
    levels = deform_dims(model)[0]
    while len(shapes) < levels:
        h, w = shapes[-1]
        shapes.append((_out(h, 3, 2, 1), _out(w, 3, 2, 1)))
    return shapes


def _msdeform_linear_flops(q: int, s: int, d: int, heads: int, levels: int,
                           points: int) -> float:
    """MSDeformAttn's products: the value over `s` rows, the offsets,
    logits and output over `q` queries."""
    lp = heads * levels * points
    return _mm(s, d, d) + _mm(q, d, 2 * lp) + _mm(q, d, lp) + _mm(q, d, d)


def sampling_items(model: dict, batch: int, H: int, W: int
                   ) -> List[Sampling]:
    detr = model["detr"]
    d, heads = int(detr["hidden_dim"]), int(detr["nheads"])
    levels, enc_points, dec_points = deform_dims(model)
    S = sum(h * w for h, w in level_shapes(model, H, W))
    Q = int(detr["num_queries"])
    return ([Sampling(f"encoder.{i}", batch, S, S, heads, d // heads, levels,
                      enc_points, 1)
             for i in range(int(detr["num_encoder_layers"]))]
            + [Sampling(f"decoder.{i}", batch, Q, S, heads, d // heads,
                        levels, dec_points, 1)
               for i in range(int(detr["num_decoder_layers"]))])


def encode_flops(model: dict, H: int, W: int, L: int) -> float:
    """One image and one L-token query through `reference.gpv_deform.
    encode`, the sampling included."""
    detr = model["detr"]
    d, D = int(detr["hidden_dim"]), int(model["hidden_dim"])
    heads = int(detr["nheads"])
    Q, ff = int(detr["num_queries"]), int(detr["dim_feedforward"])
    K1 = int(detr["num_classes"]) + 1
    levels, enc_points, dec_points = deform_dims(model)
    shapes = level_shapes(model, H, W)
    fl, h5, w5 = resnet_flops(detr, H, W)
    for lvl, (h, w) in enumerate(shapes):                  # input_proj
        cin = TRUNK_CHANNELS[lvl] if lvl < 3 else (2048 if lvl == 3 else d)
        k = 1 if lvl < 3 else 9
        fl += 2.0 * d * h * w * cin * k
    S = sum(h * w for h, w in shapes)
    fl += int(detr["num_encoder_layers"]) * (
        _msdeform_linear_flops(S, S, d, heads, levels, enc_points)
        + 2 * _mm(S, d, ff))
    fl += _mm(Q, d, 2)                                     # reference points
    fl += int(detr["num_decoder_layers"]) * (
        _mha(Q, Q, d)
        + _msdeform_linear_flops(Q, S, d, heads, levels, dec_points)
        + 2 * _mm(Q, d, ff))
    fl += sum(x.calls * x.flops() for x in sampling_items(model, 1, H, W))
    fl += _mm(Q, d, K1) + 2 * _mm(Q, d, d) + _mm(Q, d, 4)  # heads
    fl += _mm(Q, h5 * w5, 2048)                            # RoI-align
    fl += _mm(Q, d + 2048, D)                              # detr_joiner
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
    """One row's teacher-forced answer decoder over S tokens, the memory
    this detector's queries and the query tokens."""
    D, Q = int(model["hidden_dim"]), int(model["detr"]["num_queries"])
    M = Q + L
    fl = _mm(S, D, D)
    fl += int(model["text_decoder"]["num_layers"]) * (
        _mha(S, S, D) + _mha(S, M, D) + 2 * _mm(S, D, 2048))
    return fl + _mm(S, D, vocab)


def predict_flops(model: dict, vocab: int, batch: int, H: int, W: int,
                  L: int, steps: int) -> float:
    """Model FLOPs of one greedy predict call of `batch` rows."""
    return (batch * (encode_flops(model, H, W, L)
                     + decode_flops(model, L, steps, vocab))
            + classifier_flops(model, vocab))


def train_flops(model: dict, vocab: int, batch: int, unique: int, H: int,
                W: int, L: int, S: int) -> float:
    """No cell trains this family (its training reference is not
    written): raises."""
    raise NotImplementedError("gpv_deform has no training cell: no train "
                              "FLOPs are counted")


def attention_items(model: dict, batch: int, L: int,
                    steps: int) -> List[Launch]:
    """The products K1 and K2 run in a greedy predict call."""
    detr = model["detr"]
    d, heads = int(detr["hidden_dim"]), int(detr["nheads"])
    Q, D = int(detr["num_queries"]), int(model["hidden_dim"])
    co_heads = int(model["co_att"]["bi_num_attention_heads"])
    td_heads = int(model["text_decoder"]["nheads"])
    n_td = int(model["text_decoder"]["num_layers"])
    S = int(model["max_text_len"])
    bh, bl, bheads = bert_dims(model)[:3]
    return [
        Launch("detr_decoder_self", batch, Q, Q, heads, d // heads, False,
               int(detr["num_decoder_layers"])),
        Launch("bert_self", batch, L, L, bheads, bh // bheads, True, bl),
        Launch("coattention", batch, Q, L, co_heads, D // co_heads, True,
               int(model["co_att"]["num_layers"]), both=True),
        Launch("decode_self", batch, 1, S, td_heads, D // td_heads, True,
               n_td * steps),
        Launch("decode_cross", batch, 1, Q + L, td_heads, D // td_heads,
               True, n_td * steps)]


def predict_work(model: dict, batch: int, H: int, W: int, L: int,
                 steps: int) -> Dict[str, list]:
    """{kernel kind: work items} of one greedy predict call."""
    return {"attention": attention_items(model, batch, L, steps),
            "msdeform": sampling_items(model, batch, H, W)}
