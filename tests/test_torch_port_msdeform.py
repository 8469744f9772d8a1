"""GPV-1 on Deformable DETR in the port, on the CPU
(`ops/ms_deform_attn.py`, `nn/deformable_transformer.py`,
`models/deformable_detr.py`, `models/gpv.py` `build_gpv`):

- the op's plain version against the benchmark reference's sampling
  (`gpvbench/reference/gpv_deform.py`, the published
  `ms_deform_attn_core_pytorch`) and against a sample-by-sample bilinear
  read written here, on odd level sizes, points off the map and padded
  images' reference points scaled by their valid ratios;
- the port's Deformable GPV against `reference/gpv_deform.py` on seeded
  weights at a tiny size (4 levels, 1-2 layers a stack), for boxes,
  relevance logits and answer logits, with whole and padded images; the
  engine's predict over it; the training backward through the plain op,
  which training calls by name (never the kernel's wrapper); the op
  `gpv::ms_deform_attn` in a traced program; the stages' spans;
- the benchmark's check of each deformable layer
  (`gpvbench/drivers/predict_msdeform.py`) on the port's bf16 layers:
  sound, and with the sampling's value and weights in float8;
- `build_gpv` refusing an unknown detector, and the Deformable variants
  the port does not build, at once;
- the kernel's launch plan (`_plan`) at the encoder's and the decoder's
  shapes, B 1 to 20, both routes: within a block's shared memory, every
  (b, q) in exactly one block; the wrapper's refusals and their
  messages; every `__global__` of `csrc/ms_deform_attn.cu` named by a
  variant of the benchmark's `kernels/msdeform-gpv.json`, which its trace
  check matches the kernels by.

The JAX package has no deformable attention, so the yardstick here is the
benchmark's plain reference, which imports nothing of the program.
"""
import json
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gpv_tpu_torch.engine import GPVEngine
from gpv_tpu_torch.models.deformable_detr import DeformableDETR
from gpv_tpu_torch.models.gpv import build_gpv
import gpv_tpu_torch.nn.deformable_transformer as deformable_transformer
from gpv_tpu_torch.nn.deformable_transformer import (encoder_reference_points,
                                                     valid_ratios)
from gpv_tpu_torch.ops.image import normalize_image
from gpv_tpu_torch.ops import ms_deform_attn as msd
from gpv_tpu_torch.ops.ms_deform_attn import (ms_deform_attn,
                                              ms_deform_attn_plain)
from gpv_tpu_torch.text.vocab import AnswerVocab
from gpv_tpu_torch.text.wordpiece import WordPieceTokenizer
from gpv_tpu_torch.utils import profiling
from gpv_tpu_torch.utils.config import ConfigNode
from gpv_tpu_torch.weights import init_random
from gpvbench.reference import gpv_deform as R

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "gpvbench" / "configs" /
                     "gpv1-deformable-r50.json").read_text())
VOCAB = 64


def node(d):
    return ConfigNode({k: node(v) if isinstance(v, dict) else v
                       for k, v in d.items()})


def merge(base, over):
    out = json.loads(json.dumps(base))
    for k, v in over.items():
        out[k] = (merge(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out


def tiny_model(layers: int = 1, queries: int = 12) -> dict:
    """The configuration's model node at tiny widths: 4 levels, `layers`
    encoder and decoder layers, 4 heads of 8."""
    return merge(CONFIG["model"], {
        "hidden_dim": 32, "max_target_boxes": 8,
        "bert": {"hidden": 32, "num_layers": 1, "heads": 4,
                 "vocab_size": 200, "max_len": 64},
        "detr": {"hidden_dim": 32, "nheads": 4, "num_queries": queries,
                 "num_encoder_layers": layers,
                 "num_decoder_layers": layers, "dim_feedforward": 48,
                 "backbone_layers": [1, 1, 1, 1]},
        "detr_joiner": {"detr_dim": 2080, "out_dim": 32},
        "bert_joiner": {"bert_dim": 32, "out_dim": 32},
        "text_decoder": {"hidden_dim": 32, "nheads": 4, "num_layers": 1},
        "co_att": {"bi_num_attention_heads": 4, "bi_hidden_size": 32,
                   "hidden_size": 32, "intermediate_size": 48,
                   "output_size": 32, "v_hidden_size": 32,
                   "v_intermediate_size": 48, "v_output_size": 32,
                   "num_layers": 1}})


def port_and_weights(model_cfg: dict, seed: int = 5):
    W = R.make_weights(R.param_spec(model_cfg, VOCAB), seed,
                       torch.device("cpu"))
    model = build_gpv(node(model_cfg), VOCAB).eval()
    model.load_state_dict(W, strict=True)
    return model, W


# ---------------------------------------------------------------- the op

def naive_sample(value, shapes, ref, off, logits):
    """The op one sample at a time: the softmax over the (level, point)
    logits, each sample's four corners read where they lie on the map
    (pixel loc * size - 0.5), zero elsewhere."""
    B, S, H, Dh = value.shape
    Q, L, P = off.shape[1], off.shape[3], off.shape[4]
    starts = np.cumsum([0] + [h * w for h, w in shapes])
    v, r = value.double().numpy(), ref.double().numpy()
    o, lg = off.double().numpy(), logits.double().numpy()
    out = np.zeros((B, Q, H, Dh))
    for b in range(B):
        for q in range(Q):
            for h in range(H):
                a = np.exp(lg[b, q, h] - lg[b, q, h].max())
                a /= a.sum()
                for lvl, (hl, wl) in enumerate(shapes):
                    for p in range(P):
                        x = (r[b, q, lvl, 0] + o[b, q, h, lvl, p, 0] / wl) \
                            * wl - 0.5
                        y = (r[b, q, lvl, 1] + o[b, q, h, lvl, p, 1] / hl) \
                            * hl - 0.5
                        x0, y0 = math.floor(x), math.floor(y)
                        for cx, cy in ((x0, y0), (x0 + 1, y0),
                                       (x0, y0 + 1), (x0 + 1, y0 + 1)):
                            if 0 <= cx < wl and 0 <= cy < hl:
                                wgt = (1 - abs(x - cx)) * (1 - abs(y - cy))
                                out[b, q, h] += (a[lvl * P + p] * wgt * v[
                                    b, starts[lvl] + cy * wl + cx, h])
    return torch.from_numpy(out.reshape(B, Q, H * Dh))


CASES = {
    "odd_levels": ([(7, 9), (4, 5), (2, 3), (1, 2)], 1.0, False),
    "off_the_map": ([(6, 8), (3, 4), (2, 2), (1, 1)], 6.0, False),
    "padded": ([(9, 11), (5, 6), (3, 3), (2, 2)], 1.0, True),
}


def case_inputs(case: str, seed: int = 3):
    shapes, spread, padded = CASES[case]
    g = torch.Generator().manual_seed(seed)
    B, H, Dh, P = 2, 2, 4, 3
    L, S, Q = len(shapes), sum(h * w for h, w in shapes), 5
    value = torch.randn(B, S, H, Dh, generator=g)
    ratios = torch.ones(B, L, 2)
    if padded:  # image 1 fills 60% of its width and 70% of its height
        valids = []
        for h, w in shapes:
            v = torch.ones(B, h, w, dtype=torch.bool)
            v[1, max(1, round(0.7 * h)):] = False
            v[1, :, max(1, round(0.6 * w)):] = False
            valids.append(v)
        ratios = torch.stack([valid_ratios(v) for v in valids], 1)
        valid = torch.cat([v.flatten(1) for v in valids], 1)
        value = value.masked_fill(~valid[..., None, None], 0.0)
    ref = torch.rand(B, Q, 1, 2, generator=g) * ratios[:, None]
    off = spread * torch.randn(B, Q, H, L, P, 2, generator=g)
    logits = torch.randn(B, Q, H, L * P, generator=g)
    return value, shapes, ref.contiguous(), off, logits


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_op_matches_the_reference_sampling(case):
    value, shapes, ref, off, logits = case_inputs(case)
    got = ms_deform_attn(value, shapes, ref, off, logits)
    assert torch.equal(got, ms_deform_attn_plain(value, shapes, ref, off,
                                                 logits))
    B, Q, H, L, P, _ = off.shape
    norm = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32)
    loc = ref[:, :, None, :, None, :] + off / norm[None, None, None, :,
                                                    None, :]
    attn = logits.softmax(-1).view(B, Q, H, L, P)
    want = R.ms_deform_sample(R.Precision("float32"), value, shapes, loc,
                              attn)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got.double(), naive_sample(
        value, shapes, ref, off, logits), rtol=1e-5, atol=1e-6)


def test_op_on_the_cpu_counts_no_launch_and_keeps_the_dtype():
    value, shapes, ref, off, logits = case_inputs("odd_levels")
    before = dict(ms_deform_attn.variant_launches)
    out = ms_deform_attn(value.bfloat16(), shapes, ref, off.bfloat16(),
                         logits.bfloat16())
    assert out.dtype == torch.bfloat16
    assert ms_deform_attn.variant_launches == before


def test_a_traced_call_is_the_op():
    value, shapes, ref, off, logits = case_inputs("odd_levels")

    class Sample(torch.nn.Module):
        def forward(self, value, ref, off, logits):
            return ms_deform_attn(value, shapes, ref, off, logits)

    prog = torch.export.export(Sample(), (value, ref, off, logits))
    ops = [n.target for n in prog.graph.nodes if n.op == "call_function"]
    assert ops == [torch.ops.gpv.ms_deform_attn.default]
    assert torch.equal(prog.module()(value, ref, off, logits),
                       ms_deform_attn_plain(value, shapes, ref, off, logits))


def test_encoder_reference_points_are_the_valid_pixel_centres():
    shapes = [(4, 6), (2, 3)]
    valid = [torch.ones(1, h, w, dtype=torch.bool) for h, w in shapes]
    valid[0][0, 3:] = False                          # 3 of 4 rows valid
    ratios = torch.stack([valid_ratios(v) for v in valid], 1)
    assert ratios[0, 0].tolist() == [1.0, 0.75]
    ref = encoder_reference_points(shapes, ratios)
    assert ref.shape == (1, 24 + 6, 2, 2)
    # level 0's first pixel centre, (0.5 / 6, 0.5 / 3 of the valid rows),
    # scaled into level 0 by its own ratios
    torch.testing.assert_close(ref[0, 0, 0], torch.tensor(
        [0.5 / 6, 0.5 / (0.75 * 4) * 0.75]))


# ------------------------------------------------------- the whole model

def _images(B: int, H: int, W: int, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (B, H, W, 3), generator=g,
                         dtype=torch.uint8)


@pytest.mark.parametrize("padded", [False, True], ids=["whole", "padded"])
@pytest.mark.parametrize("layers", [1, 2])
def test_deformable_gpv_matches_the_reference(layers, padded):
    cfg = tiny_model(layers)
    model, W = port_and_weights(cfg)
    B, H, Wd, T = 3, 72, 100, 7
    imgs = _images(B, H, Wd)
    ids = torch.randint(6, 50, (B, T), generator=torch.Generator()
                        .manual_seed(1))
    qv = torch.ones(B, T, dtype=torch.bool)
    qv[1, 5:] = False
    iv = None
    if padded:
        iv = torch.ones(B, H, Wd, dtype=torch.bool)
        iv[1, 50:] = False
        iv[2, :, 61:] = False
    P = R.Precision("float32")
    with torch.no_grad():
        want = R.encode(P, W, cfg, imgs, ids, qv, iv)
        mem, mv, out = model.encode(normalize_image(imgs.float() / 255.0),
                                    ids, iv, qv)
        toks = torch.randint(0, VOCAB, (B, 5), generator=torch.Generator()
                             .manual_seed(2))
        la = R.answer_logits(P, W, cfg, want["memory"], want["mem_valid"],
                             toks)
        lp = model.decode_text(model.embed_answer_tokens(toks), mem, mv)
    assert out["pred_boxes"].shape == (B, 12, 4)
    torch.testing.assert_close(out["pred_boxes"], want["boxes"], rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(out["pred_relevance_logits"], want["logits"],
                               rtol=0, atol=1e-4)
    torch.testing.assert_close(mem, want["memory"], rtol=0, atol=1e-4)
    torch.testing.assert_close(lp, la, rtol=0, atol=1e-4)


def test_engine_predicts_every_query_box_sorted():
    model, _ = port_and_weights(tiny_model(queries=30))
    eng = GPVEngine(model, AnswerVocab.debug(size=VOCAB),
                    WordPieceTokenizer.debug(), max_query_len=12,
                    device="cpu", dtype=torch.float32)
    out = eng.predict(_images(2, 64, 96).numpy(),
                      ["what is this ?", "describe the picture"])
    for row in out:
        assert row["boxes"].shape == (30, 4)
        assert row["relevance"].shape == (30,)
        assert np.all(np.diff(row["relevance"]) <= 0)


def test_training_backward_reaches_the_deformable_layers(monkeypatch):
    def kernel_only(*args):
        raise AssertionError("training called the kernel's wrapper")

    monkeypatch.setattr(deformable_transformer, "ms_deform_attn",
                        kernel_only)
    model, _ = port_and_weights(tiny_model())
    model.train()
    imgs = normalize_image(_images(2, 64, 96).float() / 255.0)
    ids = torch.randint(6, 50, (2, 6))
    out = model(imgs, ids, answer_ids=torch.randint(0, VOCAB, (2, 4)),
                query_valid=torch.ones(2, 6, dtype=torch.bool), train=True)
    (out["answer_logits"].sum() + out["pred_boxes"].sum()).backward()
    grads = dict(model.named_parameters())
    for name in ("detr.transformer.level_embed",
                 "detr.transformer.encoder.layers.0.self_attn."
                 "sampling_offsets.weight",
                 "detr.transformer.encoder.layers.0.self_attn."
                 "attention_weights.weight",
                 "detr.transformer.decoder.layers.0.cross_attn."
                 "value_proj.weight",
                 "detr.transformer.reference_points.weight",
                 "detr.input_proj.3.0.weight"):
        g = grads[name].grad
        assert g is not None and g.abs().sum() > 0, name


def _float8(x):
    scale = x.float().abs().amax().clamp_min(1e-30) / 448.0
    return ((x.float() / scale).to(torch.float8_e4m3fn).float()
            * scale).to(x.dtype)


@pytest.mark.parametrize("float8", [False, True], ids=["bf16", "float8"])
def test_the_layer_check_sees_the_samplings_precision(float8, monkeypatch):
    """Each deformable layer of the port in bf16, held to the reference's
    layer on its own inputs: a sound port reads near 1 (under 2 here),
    below the configuration's limit; the same port with the sampling's
    value and attention logits rounded to float8 e4m3 reads more than
    three times as far, above the limit."""
    from gpvbench.run import load_file
    drv = load_file(ROOT / "gpvbench" / "drivers" / "predict_msdeform.py",
                    "gpvbench_driver_predict_msdeform")
    if float8:
        real = deformable_transformer.ms_deform_attn
        monkeypatch.setattr(
            deformable_transformer, "ms_deform_attn",
            lambda v, s, r, o, lg: real(_float8(v), s, r, o, _float8(lg)))
    cfg = tiny_model(2)
    model, W = port_and_weights(cfg)
    model = model.to(torch.bfloat16)
    layers = drv.deform_layers(model)
    assert sorted(layers) == [
        f"detr.transformer.{stack}.layers.{i}.{part}"
        for stack, part in (("decoder", "cross_attn"),
                            ("encoder", "self_attn")) for i in range(2)]
    seen, handles = drv.capture(layers, 2)
    imgs = normalize_image(_images(3, 72, 100).float() / 255.0)
    with torch.no_grad():
        model.encode(imgs.bfloat16(), torch.randint(6, 50, (3, 6)), None,
                     torch.ones(3, 6, dtype=torch.bool))
    for h in handles:
        h.remove()
    assert sorted(seen) == sorted(layers)
    assert all(r["query"].shape[0] == 2 for r in seen.values())
    err = drv.layer_readings(R, W, cfg, seen, False)["msdeform_err"]
    sound = 2.0
    if float8:
        assert err > max(3 * sound, CONFIG["limits"]["msdeform_err"]), err
    else:
        assert 0 < err < min(sound, CONFIG["limits"]["msdeform_err"]), err


def test_stages_are_spans_inside_encode_detr():
    model, _ = port_and_weights(tiny_model())
    profiling.drain()
    profiling.enable()
    try:
        with torch.no_grad():
            model.encode(normalize_image(_images(2, 64, 64).float() / 255),
                         torch.randint(6, 50, (2, 5)),
                         query_valid=torch.ones(2, 5, dtype=torch.bool))
    finally:
        profiling.disable()
    recs = {r.name: r for r in profiling.drain()}
    outer = recs["encode.detr"]
    for name in ("encode.deform_encoder", "encode.deform_decoder"):
        assert outer.start_ns <= recs[name].start_ns <= recs[name].end_ns \
            <= outer.end_ns


def test_init_random_sets_group_norms_as_layer_norms():
    m = DeformableDETR(num_queries=4, hidden_dim=32, nheads=4,
                       num_encoder_layers=1, num_decoder_layers=1,
                       dim_feedforward=32, backbone_layers=(1, 1, 1, 1))
    init_random(m, seed=3)
    gn = m.input_proj[3][1]
    assert torch.equal(gn.weight, torch.ones(32))
    assert torch.equal(gn.bias, torch.zeros(32))


# ------------------------------------------------------------ build_gpv

@pytest.mark.parametrize("over, match", [
    ({"detector": "detr3d"}, "model.detector='detr3d' is not a detector"),
    ({"deformable_detr": {"with_box_refine": True}}, "with_box_refine"),
    ({"deformable_detr": {"two_stage": True}}, "two_stage"),
    ({"detr": {"dilation": True}}, "dilation"),
    ({"detr": {"position_embedding": "learned"}}, "sine position"),
])
def test_build_gpv_refuses_what_it_does_not_build(over, match):
    with pytest.raises(ValueError, match=match):
        build_gpv(node(merge(tiny_model(), over)), VOCAB)


# ---- the kernel's launch plan, refusals and names ----

CELL_LEVELS = [(60, 80), (30, 40), (15, 20), (8, 10)]
CELL_S = sum(h * w for h, w in CELL_LEVELS)   # 6380


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("Q", [CELL_S, 300], ids=["encoder", "decoder"])
@pytest.mark.parametrize("B", range(1, 21))
def test_plan_fits_and_covers_every_query_once(B, Q, dtype):
    H, L, P = 8, 4, 4
    plan = msd._plan(B, Q, CELL_S, H, L, P, dtype)
    assert plan.smem_bytes <= 227 * 1024
    assert plan.smem_bytes == L * P * H * (plan.tile + 1) * msd.SLOT_BYTES
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= msd.MAX_THREADS
    assert 1 <= plan.tile <= msd.MAX_TILE
    # the kernel's mapping: block k, tile k % tiles of image k // tiles
    tiles = -(-Q // plan.tile)
    assert plan.blocks == B * tiles
    seen = np.zeros((B, Q), dtype=np.int64)
    for k in range(plan.blocks):
        b, t = divmod(k, tiles)
        seen[b, t * plan.tile:min(Q, (t + 1) * plan.tile)] += 1
    assert (seen == 1).all()
    if plan.tile < msd.MAX_TILE:   # a smaller tile only to fill the card
        assert B * -(-Q // (2 * plan.tile)) < msd.MIN_BLOCKS


@pytest.mark.parametrize("L,P", [(5, 1), (4, 9), (1, 33), (1, 0), (0, 4)])
def test_plan_refuses_what_the_kernel_does_not_take(L, P):
    with pytest.raises(ValueError, match="at most 4 levels and 32 samples "
                                         "a head"):
        msd._plan(20, 300, CELL_S, 8, L, P, torch.bfloat16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        msd._plan(20, 300, CELL_S, 8, 4, 4, torch.float16)


@pytest.mark.parametrize("dh,levels,match", [
    (64, CELL_LEVELS[:2], r"\(fp32\): head dim 64, levels \[\(60, 80\), "
                          r"\(30, 40\)\] \(2 x 2 points\) over 6000 value "
                          r"rows; the kernel takes head dim 32"),
    (32, [(60, 80), (30, 41)], r"over 6000 value rows; the kernel takes head "
                               r"dim 32, at most 4 levels and 32 samples a "
                               r"head, and levels that hold the value's rows"),
])
def test_wrapper_refusals_keep_their_messages(dh, levels, match):
    """Refused before the kernel is built or loaded, with the message the C
    entry's refusal raises."""
    B, Q, H, S = 1, 3, 2, 6000
    value = torch.zeros(B, S, H, dh)
    off = torch.zeros(B, Q, H, len(levels), 2, 2)
    logits = torch.zeros(B, Q, H, 2 * len(levels))
    ref = torch.zeros(B, Q, len(levels), 2)
    with pytest.raises(ValueError, match=match):
        msd._launch(value, levels, ref, off, logits)


@pytest.mark.parametrize("key,dtype,skew", [("value", torch.float32, 4),
                                            ("off", torch.bfloat16, 2)])
def test_wrapper_refuses_what_the_kernel_cannot_read_in_pieces(key, dtype,
                                                               skew):
    """The gathers read the value in 16-byte pieces and the offsets in
    pairs: a view that starts one element past its storage's start is
    refused before the kernel is built or loaded."""
    B, Q, H, L, P = 1, 3, 8, 2, 2
    levels = CELL_LEVELS[:L]
    S = sum(h * w for h, w in levels)
    shapes = {"value": (B, S, H, 32), "off": (B, Q, H, L, P, 2)}
    args = {k: torch.zeros(shape, dtype=dtype) for k, shape in shapes.items()}
    args[key] = torch.zeros(math.prod(shapes[key]) + 1,
                            dtype=dtype)[1:].view(shapes[key])
    logits = torch.zeros(B, Q, H, L * P, dtype=dtype)
    ref = torch.zeros(B, Q, L, 2)
    with pytest.raises(ValueError, match=f"{key} starts {skew} bytes past"):
        msd._launch(args["value"], levels, ref, args["off"], logits)


def test_every_kernel_is_named_by_a_variant_of_the_trace_check():
    src = (ROOT / "gpv_tpu_torch" / "csrc" / "ms_deform_attn.cu").read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                       r"\s+)?(\w+)\s*\(", src)
    assert len(names) == src.count("__global__") >= 2
    data = json.loads((ROOT / "gpvbench" / "kernels" /
                       "msdeform-gpv.json").read_text())
    fragments = [f for frags in data["variants"].values() for f in frags]
    for name in names:
        assert any(f in name for f in fragments), name
    assert set(msd.ms_deform_attn.variant_launches) == {
        v.split(".", 1)[1] for v in data["variants"]}

