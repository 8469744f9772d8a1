"""How the port's attention wrappers choose and size their kernels, on the
CPU (no launch): `_plan` routes each dtype and shape to the bf16 tile or
decode kernel, or the fp32 tile or decode kernel, with a block that fits
the card (above Dh 128: a cluster of CTAs, each over a slice of the head
dims), and `_aligned` refuses a tensor whose data is not 16-byte aligned.
Also `chip_smoke`'s launch routing by variant and its bound.

The byte counts mirror `tile_smem_bytes` and `decode_smem_bytes` in
gpv_tpu_torch/csrc; the CUDA entry points refuse a launch given fewer
bytes, which the card tests exercise.
"""
import importlib.util
from pathlib import Path

import pytest
import torch

from gpv_tpu_torch.ops import attention as A

ROOT = Path(__file__).resolve().parent.parent
SMEM_LIMIT = 232_448  # bytes of shared memory one H100 block may have


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHIP_SMOKE = _chip_smoke()
K1_CASES = CHIP_SMOKE.k1_cases()
K2_CASES = [c for c in CHIP_SMOKE.path_cases() if c.k2]


@pytest.mark.parametrize("case", K1_CASES, ids=lambda c: c.name)
def test_plan_routes_main_path_k1_shapes(case):
    tq, tk, dh = case.tq, case.tk, case.dh
    bf16 = A._plan(torch.bfloat16, tq, tk, dh)
    assert bf16.variant == case.variant  # what chip_smoke's gates expect
    narrow = dh <= 128  # wider heads may cut warps and keys to fit
    if tq == 1:
        assert bf16.variant == "decode"
        assert bf16.warps == min(4, -(-tk // 32)) or not narrow
    else:
        assert bf16.variant == "tile"
        assert bf16.warps == min(4, -(-tq // 16)) or not narrow
        assert bf16.key_tile == 64 or not narrow
    fp32 = A._plan(torch.float32, tq, tk, dh).variant
    decode = tq <= 8 or (tq <= 32 and tk > 64)
    assert fp32 == ("fp32_decode" if decode else "fp32_tile")
    assert fp32 == case.fp32_variant


def test_plan_routes_k2_to_the_tile_kernel():
    plan = A._plan(torch.bfloat16, 100, 20, 48, both=True)
    assert plan == A.Plan("tile", 4, 64, plan.smem_bytes)
    # one-row streams stay on the tile kernel: K2 has no decode variant
    assert A._plan(torch.bfloat16, 1, 1, 48, both=True).variant == "tile"
    assert A._plan(torch.float32, 100, 20, 48, both=True).variant == \
        "fp32_tile"


def test_plan_byte_counts_at_main_path_shapes():
    """Hand counts: 512 B of key mask, then rows of (Dh/8 | 1) 16-byte
    chunks (tile: Q rows plus K and V in two 64-key stages; decode: q in
    fp32, per-warp partials, per-warp K and V rows)."""
    # DETR encoder: Dh 32 -> 5 chunks (80 B) a row, 4 warps
    assert A._plan(torch.bfloat16, 300, 300, 32).smem_bytes == \
        512 + 64 * 80 + 4 * 64 * 80
    # BERT: Dh 64 -> 9 chunks (144 B), 2 warps
    assert A._plan(torch.bfloat16, 20, 20, 64).smem_bytes == \
        512 + 32 * 144 + 4 * 64 * 144
    # decode step over the memory: Dh 96 -> 13 chunks (208 B), 4 warps
    assert A._plan(torch.bfloat16, 1, 120, 96).smem_bytes == \
        512 + 1568 + 4 * 2 * 32 * 208


@pytest.mark.parametrize("dh", range(8, 129, 8))
def test_every_plan_fits_shared_memory(dh):
    for tq in (1, 2, 17, 64, 65, 300, 512):
        for tk in (1, 20, 33, 64, 120, 301, 512):
            for both in (False, True):
                plan = A._plan(torch.bfloat16, tq, tk, dh, both=both)
                assert 0 < plan.smem_bytes <= SMEM_LIMIT, (tq, tk, dh, plan)
                assert 1 <= plan.warps <= 4


def test_plan_refuses_what_no_kernel_takes():
    """Every head dim a config gives has a launch (Dh 12 and 136 did not
    before the kernels took any Dh, fp32 Dh 805 to 2048 not before the
    clusters); a head that needs more CTAs than one cluster may hold (Dh
    above 2048) raises naming them, and a dtype without a kernel raises."""
    assert A._plan(torch.bfloat16, 4, 4, 12).variant == "tile"
    assert A._plan(torch.bfloat16, 4, 4, 136).cols == 80
    assert A._plan(torch.float32, 300, 300, 1024).cluster == 8
    with pytest.raises(ValueError, match="a cluster of 17 CTAs of 128"):
        A._plan(torch.float32, 300, 300, 2049)
    with pytest.raises(ValueError, match="head dim 0"):
        A._plan(torch.bfloat16, 4, 4, 0)
    with pytest.raises(TypeError, match="not supported"):
        A._plan(torch.float16, 4, 4, 32)


def test_alignment_check_refuses_a_view_one_element_in():
    storage = torch.zeros(2, 9, 2, 8, dtype=torch.bfloat16)
    flat = storage.view(-1)
    assert storage.data_ptr() % 16 == 0
    A._aligned("fused_attention", {"q": storage, "k": flat[8:]})
    with pytest.raises(ValueError, match="2 bytes past a 16-byte boundary"):
        A._aligned("fused_attention", {"q": storage, "k": flat[1:]})


@pytest.mark.parametrize("K", [1, 3, 5, 20])
def test_plan_routes_beam_grouped_cross_attention(K):
    """predict_beam's cross-attention takes the K beams of a sample as K
    query rows against the 120-slot memory (Dh 96): K = 1 is the decode
    kernel; K >= 2 the tile kernel, 16 query rows a warp, so K = 5 pads
    one warp's tile and K = 20 (the HTTP limit) takes two warps."""
    plan = A._plan(torch.bfloat16, K, 120, 96)
    row = 13 * 16  # Dh 96: 12 chunks of 16 bytes, made odd
    if K == 1:
        assert plan == A.Plan("decode", 4, 32, 512 + 1568 + 4 * 2 * 32 * row)
    else:
        warps = -(-K // 16)
        assert plan == A.Plan("tile", warps, 64,
                              512 + 16 * warps * row + 2 * 2 * 64 * row)
    assert plan.smem_bytes <= SMEM_LIMIT


def test_plan_of_the_beam_cache_step_does_not_depend_on_rows():
    """B·K = 100 beam rows over the 20-slot cache: one block per (row,
    head) on the decode kernel, one warp, as at B = 20."""
    assert A._plan(torch.bfloat16, 1, 20, 96) == \
        A.Plan("decode", 1, 32, 512 + 400 + 2 * 32 * 13 * 16)


# ---- the fp32 kernels (csrc/attention.cu)

def _fp32_row(dh):
    """Floats of one padded row: ceil(Dh/4) 16-byte chunks, made odd."""
    return (-(-dh // 4) | 1) * 4


def _fp32_tile_bytes(dh, rows):
    """Hand count of `tile_smem_bytes`: the key mask of 64 keys, `rows` Q
    rows, K and V (64 rows each) in two stages, and P (`rows` rows of 72
    floats)."""
    return 4 * (64 + rows * _fp32_row(dh) + 4 * 64 * _fp32_row(dh)
                + rows * 72)


def _fp32_decode_bytes(dh, rows, warps):
    """Hand count of `decode_smem_bytes`: q (`rows` rows of ceil(Dh/4)*4
    floats) and each warp's 32 K and 32 V rows (a warp's partial sums
    reuse its K rows)."""
    d4 = -(-dh // 4) * 4
    return 4 * (rows * d4 + warps * 2 * 32 * _fp32_row(dh))


@pytest.mark.parametrize("case", [c for c in K1_CASES + K2_CASES
                                  if c.dh <= 128], ids=lambda c: c.name)
def test_fp32_plan_at_every_path_shape(case):
    """Every K1 and K2 shape of the paths in fp32 up to Dh 128 (the wider
    heads: `test_every_plan_up_to_dh_768`): the variant, warps, key tile,
    rows a block owns and shared memory equal to the hand count."""
    tq, tk, dh = case.tq, case.tk, case.dh
    plan = A._plan(torch.float32, tq, tk, dh, both=case.k2)
    if (tq <= 8 or (tq <= 32 and tk > 64)) and not case.k2:
        rows = 1 if tq == 1 else 2 if tq == 2 else 4 if tq <= 4 else 8
        warps = min(4, -(-tk // 32))
        assert plan == A.Plan("fp32_decode", warps, 32,
                              _fp32_decode_bytes(dh, rows, warps), rows)
    else:
        rows = 32 if tq <= 32 or case.k2 else 64
        assert plan == A.Plan("fp32_tile", 4, 64,
                              _fp32_tile_bytes(dh, rows), rows)
    assert plan.smem_bytes <= SMEM_LIMIT


def test_fp32_plan_byte_counts_at_main_path_shapes():
    """Literal counts: the DETR encoder (Dh 32 -> 36-float rows, 64 rows),
    BERT (Dh 64 -> 68 floats, 32 rows), the decode step over the memory
    (Dh 96 -> 100 floats, 4 warps, one row), the beam's 5 rows (8) and
    the teacher-forced 20 rows over the memory (8 a block)."""
    assert A._plan(torch.float32, 300, 300, 32) == \
        A.Plan("fp32_tile", 4, 64, 64_768, 64)
    assert A._plan(torch.float32, 20, 20, 64) == \
        A.Plan("fp32_tile", 4, 64, 4 * (64 + 32 * 68 + 256 * 68 + 32 * 72),
               32)
    assert A._plan(torch.float32, 1, 120, 96) == \
        A.Plan("fp32_decode", 4, 32, 102_784, 1)
    assert A._plan(torch.float32, 5, 120, 96) == \
        A.Plan("fp32_decode", 4, 32, 4 * (8 * 96 + 4 * 64 * 100), 8)
    assert A._plan(torch.float32, 20, 120, 96) == \
        A._plan(torch.float32, 5, 120, 96)


@pytest.mark.parametrize("tq,tk,variant,rows", [
    (1, 20, "fp32_decode", 1), (2, 20, "fp32_decode", 2),
    (3, 20, "fp32_decode", 4), (5, 120, "fp32_decode", 8),
    (8, 64, "fp32_decode", 8), (9, 64, "fp32_tile", 32),
    (9, 65, "fp32_decode", 8), (20, 20, "fp32_tile", 32),
    (20, 120, "fp32_decode", 8), (32, 65, "fp32_decode", 8),
    (32, 64, "fp32_tile", 32), (33, 120, "fp32_tile", 64),
    (300, 300, "fp32_tile", 64)])
def test_fp32_threshold_between_decode_and_tile(tq, tk, variant, rows):
    """K1 fp32 calls of at most 8 query rows take the decode variant (a
    block of 1, 2, 4 or 8 row slots), and so do calls of at most 32 rows
    over more than one 64-key tile (8 rows a block); the others the tile
    variant (32 rows up to Tq 32, then 64). K2 always takes the tile
    variant at 32 rows a block."""
    plan = A._plan(torch.float32, tq, tk, 96)
    assert (plan.variant, plan.rows) == (variant, rows)
    k2 = A._plan(torch.float32, tq, min(tq, 20), 48, both=True)
    assert (k2.variant, k2.rows) == ("fp32_tile", 32)


@pytest.mark.parametrize("dh", [1, 2, 3, 5, 7, 8, 30, 31, 32, 33, 48, 63, 64,
                                65, 96, 97, 127, 128])
def test_every_fp32_plan_fits_shared_memory(dh):
    """Any Dh up to 128, also one that is not a multiple of 4."""
    for tq in (1, 2, 5, 8, 9, 33, 300):
        for tk in (1, 20, 33, 120, 301):
            for both in (False, True):
                plan = A._plan(torch.float32, tq, tk, dh, both=both)
                assert 0 < plan.smem_bytes <= SMEM_LIMIT, (tq, tk, dh)
                assert plan.smem_bytes % 16 == 0
                assert 1 <= plan.warps <= 4


def test_fp32_plan_takes_head_dims_above_128():
    """Head dims above 128 are not refused: they run on a cluster of CTAs
    over slices of at most 128 dims (129 splits into two of 80: q and each
    warp's K and V rows over 80 dims, and the warp's partial scores of 4
    rows); only a head that needs more CTAs than a cluster
    may hold is refused, naming them."""
    assert A._plan(torch.float32, 4, 4, 129) == A.Plan(
        "fp32_decode", 1, 32, 4 * (4 * 80 + 2 * 32 * 84 + 4 * 32), 4, 80, 2)
    with pytest.raises(ValueError, match="above the 16 one H100 cluster"):
        A._plan(torch.float32, 4, 4, 4096)


def test_fp32_launches_route_by_plan():
    """`chip_smoke.by_variant` of an fp32 predict: DETR, BERT and K2 on
    the fp32 tile kernel, the decode step's 114 calls on fp32 decode, the
    bf16 kernels none; a bf16 predict leaves the fp32 kernels at 0."""
    counts = CHIP_SMOKE.path_launches("predict", 19)
    assert CHIP_SMOKE.by_variant(counts, "float32") == {
        "fused_attention": {"tile": 0, "decode": 0, "fp32_tile": 30,
                            "fp32_decode": 114},
        "fused_biattention": {"tile": 0, "fp32_tile": 3}}
    assert CHIP_SMOKE.by_variant(counts) == {
        "fused_attention": {"tile": 30, "decode": 114, "fp32_tile": 0,
                            "fp32_decode": 0},
        "fused_biattention": {"tile": 3, "fp32_tile": 0}}
    beam = CHIP_SMOKE.by_variant(
        CHIP_SMOKE.path_launches("predict_beam", 19), "float32")
    assert beam["fused_attention"] == {"tile": 0, "decode": 0,
                                       "fp32_tile": 30, "fp32_decode": 114}
    # the wrappers count the same keys
    assert set(A.fused_attention.variant_launches) == \
        set(CHIP_SMOKE.by_variant(counts)["fused_attention"])
    assert set(A.fused_biattention.variant_launches) == \
        set(CHIP_SMOKE.by_variant(counts)["fused_biattention"])


@pytest.mark.parametrize("dtype,bound_us,by", [
    ("float32", 27.51, "operations"), ("bfloat16", 3.668, "bytes")])
def test_bound_of_the_detr_encoder(dtype, bound_us, by):
    """`_bound` at the DETR encoder (B 20, 300 x 300, 8 heads of 32): q,
    k, v read and out written once, 4 B H Tq Tk Dh operations. fp32 runs
    with TF32 off, on the CUDA cores' 67 TFLOP/s: 1.84 GFLOP take 27.5 us
    against 7.3 us for its 24.6 MB. bf16 at 989 TFLOP/s is bound by its
    12.3 MB."""
    b, t, h, dh = 20, 300, 8, 32
    size = 4 if dtype == "float32" else 2
    rec = CHIP_SMOKE._bound(4 * b * t * h * dh * size,
                            4.0 * b * h * t * t * dh, dtype)
    assert rec["bound_by"] == by
    assert 1e3 * rec["bound_ms"] == pytest.approx(bound_us, rel=1e-3)
    assert CHIP_SMOKE.PEAK_FLOPS == {"bfloat16": 989e12, "float32": 67e12}


def test_bound_of_a_deformable_encoder_layer():
    """`_bound` of one deformable encoder layer's sampling at B 20 (S = Q =
    6380 rows, 8 heads of 32, 4 levels x 4 points), in bf16: the value,
    offsets, logits and output at 2 B, the reference points at 4 B: 0.233
    GB, bound by its bytes at 69.5 us; its 5.2 GFLOP take 5.3 us."""
    b, s, h, dh, l, p = 20, 6380, 8, 32, 4, 4
    nbytes = 2 * b * s * (2 * h * dh + h * l * p * 3) + 4 * b * s * l * 2
    rec = CHIP_SMOKE._bound(nbytes, b * s * h * l * p * dh * 10.0,
                            "bfloat16")
    assert rec["bound_by"] == "bytes"
    assert 1e3 * rec["bound_ms"] == pytest.approx(69.475, rel=1e-3)


def test_kernels_line_lists_the_fp32_kernels():
    """`chip_smoke.kernels_line` gives every kernel of the paths an entry:
    the three bf16 ones counted on the bf16 predict, the three fp32 ones
    (attention.cu) on the fp32 predict, each shape's per-launch numbers
    (all 1 here) summed over that run's launches; and the deformable
    sampling kernel's two routes, each on its Deformable predict (6
    encoder and 6 decoder layers)."""
    keys = ("ms", "device_ms", "plain_ms", "plain_device_ms", "library_ms",
            "library_device_ms", "bound_ms", "bytes_ms", "ops_ms")
    one = dict.fromkeys(keys, 1.0)
    k1 = [{"case": c.name, "dtype": d, "max_abs_err": 0.0, **one,
           "variant": c.variant if d == "bfloat16" else c.fp32_variant}
          for c in K1_CASES for d in ("float32", "bfloat16")]
    k2 = [{"case": c.name, "dtype": d, "max_abs_err": 0.0, **one,
           "variant": "tile" if d == "bfloat16" else "fp32_tile",
           "library_ms": None, "library_device_ms": None,
           "sdpa_two_calls_ms": 1.0, "sdpa_two_calls_device_ms": 1.0}
          for c in K2_CASES for d in ("float32", "bfloat16")]
    counts = CHIP_SMOKE.path_launches("predict", 19)
    line = CHIP_SMOKE.kernels_line(
        {"K1": k1, "K2": k2},
        {"predict": ({"launches_by_variant": CHIP_SMOKE.by_variant(counts),
                      "decode_steps": 19}, counts)},
        {"predict": ({"launches_by_variant":
                      CHIP_SMOKE.by_variant(counts, "float32"),
                      "decode_steps": 19}, counts)},
        {"cases": [{"case": c, "dtype": d, "max_abs_err": 0.0,
                    **dict.fromkeys(keys + ("op_ms",), 1.0)}
                   for c in ("encoder", "decoder")
                   for d in ("float32", "bfloat16")],
         "predict": {d: {"ms": 1.0, "launches_by_variant": {
             "ms_deform_attn": {"bf16": 12 * (d == "bfloat16"),
                                "fp32": 12 * (d == "float32")}}}
             for d in ("float32", "bfloat16")}})
    got = {e["name"]: (e["source"].rsplit("/", 1)[1], e["replaces"],
                       e["launches"], e["device_ms"], e["library_ms"])
           for e in line["kernels"]}
    assert got == {
        "fused_attention[tile]": ("attention_tile.cu",
                                  "gpv_tpu/ops/attention.py:55", 30, 30.0,
                                  30.0),
        "fused_attention[decode]": ("attention_decode.cu",
                                    "gpv_tpu/ops/attention.py:55", 114,
                                    114.0, 114.0),
        "fused_biattention[tile]": ("attention_tile.cu",
                                    "gpv_tpu/ops/attention.py:147", 3, 3.0,
                                    None),
        "fused_attention[fp32_tile]": ("attention.cu",
                                       "gpv_tpu/ops/attention.py:55", 30,
                                       30.0, 30.0),
        "fused_attention[fp32_decode]": ("attention.cu",
                                         "gpv_tpu/ops/attention.py:55", 114,
                                         114.0, 114.0),
        "fused_biattention[fp32_tile]": ("attention.cu",
                                         "gpv_tpu/ops/attention.py:147", 3,
                                         3.0, None),
        "ms_deform_attn[bf16]": ("ms_deform_attn.cu", None, 12, 12.0, None),
        "ms_deform_attn[fp32]": ("ms_deform_attn.cu", None, 12, 12.0, None)}
    fp32 = [e for e in line["kernels"] if "fp32" in e["name"]]
    assert all(e["route"] == "cuda" and "fp32" in e["per"] for e in fp32)


# ---- every head dim: 1 to 2048, both dtypes

K1_TQ, K1_TK = (1, 5, 20, 100, 300), (20, 120, 300)
K2_SHAPES = ((100, 20), (20, 100), (1, 1), (33, 65))  # (longer, shorter)
CALLS = ([(tq, tk, False) for tq in K1_TQ for tk in K1_TK]
         + [(t1, t2, True) for t1, t2 in K2_SHAPES])


def _cols_hand(dh):
    """Head dims a CTA holds: all up to 128, else Dh split into the fewest
    slices of at most 128, evened out, rounded up to 16."""
    if dh <= 128:
        return 0
    n = -(-dh // 128)
    return -(-(-(-dh // n)) // 16) * 16


def _bf16_row(d):
    """`row_chunks(d) * 16`: ceil(d/8) 16-byte chunks, made odd."""
    return (-(-d // 8) | 1) * 16


def _source_bytes(plan, dh):
    """The CUDA sources' byte counts, written out from each `*_smem_bytes`
    (attention_tile.cu, attention_decode.cu, attention.cu) for the plan's
    warps, rows, key tile and the head dims a block holds (Dh, or a cluster
    CTA's slice, with every thread's partial scores of a tile)."""
    w, wide, kt = plan.cols or dh, plan.cluster > 1, plan.key_tile
    if plan.variant == "tile":
        row = _bf16_row(plan.cols or -(-dh // 16) * 16)
        return (2 * 64 * 4 + 16 * plan.warps * row + 2 * 64 * 2 * row
                + (plan.warps * 32 * 32 * 4 if wide else 0))
    if plan.variant == "decode":
        q = 4 * max(128, -(-w // 8) * 8)
        part = -(-(4 * plan.warps * (-(-w // 8) * 8 + 2)) // 16) * 16
        return (q + part + (plan.warps * 32 * 4 if wide else 0)
                + plan.warps * 32 * 2 * _bf16_row(w))
    if plan.variant == "fp32_decode":
        return 4 * (plan.rows * -(-w // 4) * 4
                    + plan.warps * 2 * 32 * _fp32_row(w)
                    + (plan.warps * plan.rows * 32 if wide else 0))
    return 4 * (kt + plan.rows * _fp32_row(w) + 4 * kt * _fp32_row(w)
                + plan.rows * (kt + 8) + (plan.rows * kt if wide else 0))


def _plan_before_wide_heads(dtype, tq, tk, dh, both=False):
    """The plans the kernels took up to Dh 128 before they took every head
    dim (bf16: multiples of 8 only), written down as they were: the new
    plans must equal them wherever these exist."""
    if dtype == torch.float32:
        f, d4 = _fp32_row(dh), -(-dh // 4) * 4
        if (tq <= 8 or (tq <= 32 and tk > 64)) and not both:
            rows = min(8, 1 << (tq - 1).bit_length())
            warps = min(4, -(-tk // 32))
            return A.Plan("fp32_decode", warps, 32,
                          4 * (rows * d4 + warps * 2 * 32 * f), rows)
        rows = 32 if tq <= 32 or both else 64
        return A.Plan("fp32_tile", 4, 64,
                      4 * (64 + rows * f + 4 * 64 * f + rows * 72), rows)
    if tq == 1 and not both:
        warps = min(4, -(-tk // 32))
        part = -(-(4 * warps * (dh + 2)) // 16) * 16
        return A.Plan("decode", warps, 32,
                      512 + part + warps * 2 * 32 * _bf16_row(dh))
    warps, row = min(4, -(-tq // 16)), _bf16_row(-(-dh // 16) * 16)
    return A.Plan("tile", warps, 64, 512 + 16 * warps * row + 4 * 64 * row)


# today's plans at the main path's shapes, literally
NARROW_PLANS = {
    ("bfloat16", 300, 300, 32, False): A.Plan("tile", 4, 64, 26112),
    ("bfloat16", 20, 20, 64, False): A.Plan("tile", 2, 64, 41984),
    ("bfloat16", 1, 120, 96, False): A.Plan("decode", 4, 32, 55328),
    ("bfloat16", 1, 20, 96, False): A.Plan("decode", 1, 32, 14224),
    ("bfloat16", 5, 120, 96, False): A.Plan("tile", 1, 64, 57088),
    ("bfloat16", 100, 20, 48, True): A.Plan("tile", 4, 64, 36352),
    ("float32", 300, 300, 32, False): A.Plan("fp32_tile", 4, 64, 64768, 64),
    ("float32", 1, 120, 96, False): A.Plan("fp32_decode", 4, 32, 102784, 1),
    ("float32", 20, 120, 96, False): A.Plan("fp32_decode", 4, 32, 105472,
                                            8),
    ("float32", 100, 20, 48, True): A.Plan("fp32_tile", 4, 64, 69376, 32),
}


@pytest.mark.parametrize("key", list(NARROW_PLANS), ids=str)
def test_plans_up_to_dh_128_are_unchanged(key):
    dtype, tq, tk, dh, both = key
    plan = A._plan(getattr(torch, dtype), tq, tk, dh, both=both)
    assert plan == NARROW_PLANS[key] == _plan_before_wide_heads(getattr(torch, dtype), tq,
                                                tk, dh, both)
    assert plan.cols == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("first", range(1, 2049, 128))
def test_every_head_dim_up_to_2048_plans(dtype, first):
    """F5: every Dh in [first, first + 128) plans at the K1 shapes (Tq
    1/5/20/100/300 over Tk 20/120/300) and K2's four stream pairs, with a
    block of at most 227 KB. Before the clusters, fp32 refused from Dh 805
    and bf16 from 2321 (a block held whole Dh-wide Q and K rows)."""
    for dh in range(first, first + 128):
        for tq, tk, both in CALLS:
            plan = A._plan(dtype, tq, tk, dh, both=both)
            assert 0 < plan.smem_bytes <= SMEM_LIMIT, (dh, tq, tk, plan)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("first", range(1, 769, 64))
def test_every_plan_up_to_dh_768(dtype, first):
    """For every Dh in [first, first + 64), K1 at Tq 1/5/20/100/300 against
    Tk 20/120/300 and K2 at four stream pairs: `_plan` returns the variant
    of the routing (fp32 teacher-forced rows, Tq <= 32 over Tk > 64, on the
    decode variant, above Dh 128 with 2 warps a CTA), 64-key tiles (fp32
    tiles on a cluster: 32 keys and 32 rows), a cluster of
    ceil(Dh / 128) CTAs above Dh 128 whose slices cover the head, a block
    whose bytes equal the source's count and fit 227 KB; up to 128 the
    plan is the one the kernels took before (bf16: where Dh was a multiple
    of 8)."""
    for dh in range(first, first + 64):
        for tq, tk, both in CALLS:
            plan = A._plan(dtype, tq, tk, dh, both=both)
            bf16 = dtype == torch.bfloat16
            one = tq == 1 and not both
            if bf16:
                assert plan.variant == ("decode" if one else "tile")
            else:
                decode = (tq <= 8 or (tq <= 32 and tk > 64)) and not both
                assert plan.variant == ("fp32_decode" if decode
                                        else "fp32_tile")
                if decode:  # teacher-forced rows on a cluster: 2 warps
                    two = tq > 8 and dh > 128
                    assert plan.warps == min(2 if two else 4, -(-tk // 32))
            assert plan.cols == _cols_hand(dh)
            n = -(-dh // 128) if dh > 128 else 0
            assert plan.cluster == n
            assert not n or (n - 1) * plan.cols < dh <= n * plan.cols
            assert plan.smem_bytes == _source_bytes(plan, dh), (dh, tq, tk)
            assert 0 < plan.smem_bytes <= SMEM_LIMIT, (dh, tq, tk, plan)
            assert 1 <= plan.warps <= 4
            if plan.variant == "tile" or (plan.variant == "fp32_tile"
                                          and not n):
                assert plan.key_tile == 64
            elif plan.variant == "fp32_tile":
                assert (plan.key_tile, plan.rows) == (32, 32)
            if dh <= 128 and (not bf16 or dh % 8 == 0):
                assert plan == _plan_before_wide_heads(dtype, tq, tk, dh, both), (dh, tq)


def test_column_blocks_cover_the_head_evenly():
    """Above Dh 128 a head runs on a cluster of ceil(Dh / 128) CTAs (a
    portable cluster of at most 8 up to Dh 1024, 16 at most up to 2048),
    each holding a slice of at most 128 dims (a multiple of 16), none of
    them empty; a CTA's shared memory is the same at every Dh from 1024 up
    (slices of 128)."""
    for dh in range(129, 2049):
        cols = A._cols(dh)
        n = A._cluster(dh, cols)
        assert cols % 16 == 0 and cols <= 128
        assert n == -(-dh // 128) and (n - 1) * cols < dh <= n * cols
        assert n <= (8 if dh <= 1024 else 16)
    assert [A._cols(d) for d in (136, 192, 256, 384, 768)] == \
        [80, 96, 128, 128, 128]
    assert [A._cluster(d, A._cols(d)) for d in (136, 192, 256, 384, 768,
                                               1024, 2048)] == \
        [2, 2, 2, 3, 6, 8, 16]
    for dtype in (torch.float32, torch.bfloat16):
        for tq, tk, both in CALLS:
            at = {dh: A._plan(dtype, tq, tk, dh, both).smem_bytes
                  for dh in (1024, 1536, 2048)}
            assert len(set(at.values())) == 1, (dtype, tq, tk, at)


def test_kernels_record_summarises_each_wide_case():
    """`chip_smoke.vs_sdpa`: a `kernels` case in short, as the `wide` list
    prints it: device, plain, bound and SDPA (K2: its two calls) in us, the
    kernel over its bound and over SDPA, and the cluster it launched
    with."""
    rec = {"case": "teacher_forced_cross_h1", "dtype": "float32",
           "shape": [20, 20, 120, 1, 768], "variant": "fp32_decode",
           "cluster": 6, "device_ms": 0.0371, "plain_device_ms": 0.0344,
           "bound_ms": 0.00514, "library_device_ms": 0.0551}
    got = CHIP_SMOKE.vs_sdpa(rec)
    assert got == {"case": "teacher_forced_cross_h1", "dtype": "float32",
                   "shape": [20, 20, 120, 1, 768], "variant": "fp32_decode",
                   "cluster": 6, "device_us": 37.1, "plain_us": 34.4,
                   "bound_us": 5.14, "sdpa_us": 55.1, "x_bound": 7.22,
                   "x_sdpa": 0.673}
    k2 = dict(rec, library_device_ms=None, sdpa_two_calls_device_ms=0.0742)
    assert CHIP_SMOKE.vs_sdpa(k2)["x_sdpa"] == 0.5
    assert A._plan(torch.float32, 20, 120, 768).cluster == 6
