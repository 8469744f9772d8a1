"""Work counted from shapes: GPV-1's counts (`counts/gpv.py`) against
torch's FLOP counter on the reference, and the frozen copy of the bound
against `chip_smoke.py`'s arithmetic on the kernel table's cases (counts,
not times)."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from gpvbench import flops, peaks
from gpvbench.counts import gpv as counts
from gpvbench.build import answer_words
from gpvbench.reference import gpv as ref
from gpvbench.tests.tiny import TINY_MODEL, merge

ROOT = Path(__file__).resolve().parents[2]


def _model(dilation: bool) -> dict:
    import json
    conf = json.loads((ROOT / "gpvbench/configs/gpv1-r50.json").read_text())
    model = merge(conf["model"], TINY_MODEL)
    model["detr"]["dilation"] = dilation
    return model


@pytest.mark.parametrize("dilation", [False, True])
def test_predict_flops_match_the_flop_counter(dilation):
    model, V, B, H, W, L, S = _model(dilation), 64, 3, 64, 96, 20, 19
    w = ref.make_weights(ref.param_spec(model, V), 1, "cpu")
    P = ref.Precision("float32")
    images = torch.randint(0, 256, (B, H, W, 3), dtype=torch.uint8)
    ids = torch.randint(5, 200, (B, L))
    valid = torch.arange(L)[None].expand(B, L) < 12
    tokens = torch.randint(0, V, (B, S))
    with FlopCounterMode(display=False) as fc:
        e = ref.encode(P, w, model, images, ids, valid)
        ref.answer_logits(P, w, model, e["memory"], e["mem_valid"], tokens)
    assert fc.get_total_flops() == counts.predict_flops(model, V, B, H, W,
                                                       L, S)
    assert len(answer_words(V)) == V


def test_train_forward_flops_match_the_flop_counter():
    """A train step's forward over 20 answer tokens, every query row
    through BERT (no dedup): what the reference runs."""
    model, V, B, H, W, L, S = _model(False), 64, 2, 64, 64, 20, 20
    w = ref.make_weights(ref.param_spec(model, V), 2, "cpu")
    P = ref.Precision("float32")
    images = torch.randint(0, 256, (B, H, W, 3), dtype=torch.uint8)
    ids = torch.randint(5, 200, (B, L))
    valid = torch.ones(B, L, dtype=torch.bool)
    with FlopCounterMode(display=False) as fc:
        e = ref.encode(P, w, model, images, ids, valid)
        ref.answer_logits(P, w, model, e["memory"], e["mem_valid"],
                          torch.randint(0, V, (B, S)))
    assert fc.get_total_flops() == counts.train_forward_flops(
        model, V, B, B, H, W, L, S)
    total = counts.train_flops(model, V, B, B, H, W, L, S)
    assert 2 * fc.get_total_flops() < total < 3 * fc.get_total_flops()


def test_launches_follow_the_shapes():
    model = _model(True)
    ls = {x.name: x for x in counts.predict_launches(model, 20, 480, 640, 20,
                                                    19)}
    # DC5 at 480x640: C5 at stride 16, 30 x 40 tokens
    assert ls["detr_encoder_self"].tq == ls["detr_encoder_self"].tk == 1200
    assert ls["decode_cross"].tk == 10 + 20 and ls["decode_self"].calls == 19


def test_bound_is_chip_smokes_arithmetic():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    cases = [  # (bytes, flops, dtype) of PERF.md's kernel table's shapes
        (flops.Launch("detr_encoder", 20, 300, 300, 8, 32, False, 1), 2),
        (flops.Launch("bert_self", 20, 20, 20, 12, 64, True, 1), 2),
        (flops.Launch("decode_cross", 20, 1, 120, 8, 96, True, 1), 2),
        (flops.Launch("k2", 20, 100, 20, 16, 48, True, 1, both=True), 2),
        (flops.Launch("detr_encoder", 20, 300, 300, 8, 32, False, 1), 4)]
    for launch, elt in cases:
        dtype = "bfloat16" if elt == 2 else "float32"
        got = peaks.bound(launch.bytes(elt), launch.flops(), dtype)
        want = chip_smoke._bound(launch.bytes(elt), launch.flops(), dtype)
        assert got == want
    assert (peaks.HBM_BYTES_PER_S, peaks.PEAK_FLOPS) == (
        chip_smoke.HBM_BYTES_PER_S, chip_smoke.PEAK_FLOPS)
    # PERF.md: the DETR encoder's K1 at 300x300, 8 heads of 32, bound
    # 3.67 us by its bytes (2 x q + k + v in bf16, no mask)
    enc = cases[0][0]
    assert enc.bytes(2) == 4 * 20 * 300 * 8 * 32 * 2
    assert peaks.bound(enc.bytes(2), enc.flops(), "bfloat16")[
        "bound_ms"] == pytest.approx(3.668e-3, rel=1e-3)
