"""The plain reference against the program (`gpv_tpu_torch`) at tiny widths
in fp32 on the CPU: the same names and shapes of weights at the released
widths, the same encode outputs, the same greedy logits."""
from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from gpvbench import build
from gpvbench.reference import gpv as ref
from gpvbench.tests.tiny import TINY_MODEL, merge

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _conf(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["gpv1-r50", "gpv1-dc5-r50"])
def test_weights_are_the_programs_at_released_widths(name):
    from gpv_tpu_torch.models.gpv import build_gpv
    conf = _conf(name)
    with torch.device("meta"):
        model = build_gpv(build.node(conf["model"]), conf["vocab_size"])
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {n: tuple(s) for n, s, _ in ref.param_spec(conf["model"],
                                                     conf["vocab_size"])}
    assert got == want


@pytest.fixture(scope="module", params=[False, True], ids=["r50", "dc5"])
def pair(request):
    from gpv_tpu_torch.models.gpv import build_gpv
    model = merge(_conf("gpv1-r50")["model"], TINY_MODEL)
    model["detr"]["dilation"] = request.param
    V = 64
    w = ref.make_weights(ref.param_spec(model, V), 3, "cpu")
    port = build_gpv(build.node(model), V).eval()
    port.load_state_dict(w, strict=True)
    g = torch.Generator().manual_seed(0)
    B, L = 3, 20
    images = torch.randint(0, 256, (B, 64, 96, 3), dtype=torch.uint8,
                           generator=g)
    ids = torch.randint(5, 200, (B, L), generator=g)
    valid = torch.arange(L)[None].expand(B, L) < torch.tensor([[12], [7],
                                                               [20]])
    return model, V, w, port, images, ids, valid


def test_encode_matches(pair):
    from gpv_tpu_torch.ops.image import normalize_image
    model, V, w, port, images, ids, valid = pair
    with torch.no_grad():
        mem, mv, out = port.encode(normalize_image(images.float() / 255.0),
                                   ids, None, valid)
        e = ref.encode(ref.Precision(), w, model, images, ids, valid)
        rmem, rmv, rel, boxes = (e["memory"], e["mem_valid"], e["relevance"],
                                 e["boxes"])
    prob = out["pred_relevance_logits"].softmax(-1)[..., 0]
    torch.testing.assert_close(rel, prob, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(boxes, out["pred_boxes"], rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(rmem, mem, rtol=1e-4, atol=1e-4)
    assert torch.equal(rmv, mv)


def test_greedy_logits_match(pair):
    from gpv_tpu_torch.decode.greedy import greedy_decode
    from gpv_tpu_torch.ops.image import normalize_image
    model, V, w, port, images, ids, valid = pair
    cls = build.answer_words(V).index("__cls__")
    with torch.no_grad():
        mem, mv, _ = port.encode(normalize_image(images.float() / 255.0),
                                 ids, None, valid)
        tokens, logits, steps = greedy_decode(port, mem, mv, cls)
        inp = torch.cat([torch.full((3, 1), cls), tokens[:, :-1].long()], 1)
        e = ref.encode(ref.Precision(), w, model, images, ids, valid)
        got = ref.answer_logits(ref.Precision(), w, model, e["memory"],
                                e["mem_valid"], inp)
    assert steps == 19
    torch.testing.assert_close(got, logits, rtol=1e-4, atol=1e-4)


def test_tokenizer_is_the_programs():
    from gpv_tpu_torch.text.wordpiece import WordPieceTokenizer
    traffic = json.loads((CONFIGS.parent / "traffic" /
                          "predict-greedy.json").read_text())
    words = build.bert_words(traffic)
    qs = [t.format(*traffic["objects"][:t.count("{}")])
          for t in traffic["templates"]]
    ids, valid = ref.tokenize(words, qs, 20)
    pids, pvalid = WordPieceTokenizer(words).batch_encode(qs, 20)
    assert ids.tolist() == pids.tolist() and valid.tolist() == \
        pvalid.tolist()
    assert valid.sum(1).tolist() == [12] * len(qs)


def test_roi_align_is_torchvisions_on_hand_cases():
    """One RoI over a 4x4 map: the aligned sampling of torchvision's
    roi_align, worked by hand (a constant map gives the constant; a ramp
    gives the ramp's value at the box centre)."""
    feats = torch.arange(16, dtype=torch.float32).view(1, 1, 4, 4)
    box = torch.tensor([[[0.5, 0.5, 0.5, 0.5]]])   # centre, half the map
    got = ref.roi_align_mean(feats.expand(1, 3, 4, 4).contiguous(), box)
    # centre (x, y) = (2 - 0.5, 2 - 0.5) in pixel centres: 1.5*4 + 1.5
    torch.testing.assert_close(got, torch.full((1, 1, 3), 7.5))
    ones = torch.ones(1, 2, 5, 7)
    box = torch.tensor([[[0.3, 0.6, 0.4, 0.5], [0.9, 0.1, 0.3, 0.2]]])
    # inside the map, or past its edge by less than a pixel (clamped)
    torch.testing.assert_close(ref.roi_align_mean(ones, box),
                               torch.ones(1, 2, 2))


def test_rounding_only_leaves_out_exact_zeros_by_the_reference():
    import torch
    from gpvbench.judge import parts, rounding_only
    g = torch.Generator().manual_seed(3)
    grad = {"w": torch.randn(64, 64, generator=g),
            "attn.in_proj_bias": torch.cat([torch.randn(8, generator=g),
                                            1e-9 * torch.randn(8, generator=g),
                                            torch.randn(8, generator=g)]),
            "head.bias": 1e-2 * torch.randn(8, generator=g),
            "small.bias": 1e-2 * torch.randn(8, generator=g)}
    # the batch's rows reordered: real gradients move by rounding (1e-6 of
    # themselves), the head bias, an exact zero read through cancelling
    # sums, by as much as itself
    again = {n: t * (1 + 1e-6 * torch.randn(t.shape, generator=g))
             for n, t in grad.items()}
    again["head.bias"] = 1e-2 * torch.randn(8, generator=g)
    assert sorted(parts(grad)) == [
        "attn.in_proj_bias[k]", "attn.in_proj_bias[q]",
        "attn.in_proj_bias[v]", "head.bias", "small.bias", "w"]
    assert rounding_only(grad, again) == ["attn.in_proj_bias[k]",
                                          "head.bias"]
