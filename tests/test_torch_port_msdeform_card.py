"""The multi-scale deformable attention kernel (`csrc/ms_deform_attn.cu`,
`ops.ms_deform_attn`) on the card against its plain version in fp32, at
the published widths of Deformable DETR in GPV-1 (hidden 256, 8 heads of
32, 4 levels x 4 points; 480x640 images: levels 60x80, 30x40, 15x20 and
8x10, S = 6380 rows):

- the encoder's call (Q = S) and the decoder's (Q = 300), the bf16 and
  the fp32 route, and a call on odd level sizes with padded images and
  points thrown far off the map;
- each route counted on its own `variant_launches` entry, once a call;
- a call with a gradient raises (the kernel is forward-only), training's
  layer takes the plain op, and a traced program's op launches the
  kernel;
- anything but a head dim of 32 refused by the kernel's C entry;
- the tile of queries a block takes (`_plan`): Q at the planned tile, one
  below and one above it, and Q = 1;
- the encoder at the cell's shape (B=20, S = Q = 6380) and at B=1, its
  reference points the pixel centres in query order (as the model's);
- samples exactly on a map's edges and samples whose every corner lies
  outside (level sizes that are powers of two, so that both versions
  place them exactly);
- one to four levels, with L * P up to the kernel's 32 samples;
- a call captured as a CUDA graph (`ops.cuda_graph.capture`) and
  replayed: equal bit for bit to the eager call, one launch a replay.

Tolerances, against the plain version on the same (bf16-rounded) inputs
in fp32:
- fp32 route: 1e-4 of the largest value. Both compute the locations in
  fp32, but `grid_sample` unnormalises 2 * loc - 1 where the kernel scales
  loc: the same pixel coordinate rounded differently, by up to an ulp at
  80 pixels (7.6e-6), which moves a bilinear weight as much; the sums of
  64 corner products in another order add a few ulps more.
- bf16 route: 2^-8 of the largest output beside that: the output is
  written in bf16 (a relative rounding of 2^-9) from the same fp32 sum.

Card only: every test is marked `cuda` and skips without a CUDA device.
The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda \\
        tests/test_torch_port_msdeform_card.py
"""
import pytest
import torch

from gpv_tpu_torch.ops import cuda_graph
from gpv_tpu_torch.ops.ms_deform_attn import (_plan, ms_deform_attn,
                                              ms_deform_attn_plain)

pytestmark = pytest.mark.cuda

LEVELS = [(60, 80), (30, 40), (15, 20), (8, 10)]
ODD = [(37, 53), (19, 27), (10, 14), (5, 7)]
H, DH, P = 8, 32, 4
CASES = {"encoder": (2, None, LEVELS, 1.0, False),
         "decoder": (4, 300, LEVELS, 1.0, False),
         "odd_padded_far": (3, 211, ODD, 20.0, True)}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(case, dtype, device):
    B, Q, shapes, spread, padded = CASES[case]
    S = sum(h * w for h, w in shapes)
    Q = S if Q is None else Q
    L = len(shapes)
    g = torch.Generator(device=device).manual_seed(17)
    value = torch.randn(B, S, H, DH, generator=g, device=device)
    if padded:  # zeroed rows, as a padded image's value is
        value[1, S // 2:] = 0
    ref = torch.rand(B, Q, L, 2, generator=g, device=device)
    if padded:  # reference points scaled into a valid extent
        ref[1] *= torch.tensor([0.6, 0.8], device=device)
    off = spread * torch.randn(B, Q, H, L, P, 2, generator=g, device=device)
    logits = torch.randn(B, Q, H, L * P, generator=g, device=device)
    return ([t.to(dtype) for t in (value, off, logits)], ref.contiguous(),
            shapes)


def _assert_matches(value, shapes, ref, off, logits, label):
    """One launch of the kernel against the plain version in fp32 at the
    module's tolerances, counted on its route's entry."""
    dtype = value.dtype
    variant = "bf16" if dtype == torch.bfloat16 else "fp32"
    before = dict(ms_deform_attn.variant_launches)
    with torch.no_grad():
        got = ms_deform_attn(value, shapes, ref, off, logits)
        want = ms_deform_attn_plain(value.float(), shapes, ref, off.float(),
                                    logits.float())
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    assert ms_deform_attn.variant_launches[variant] == before[variant] + 1
    scale = value.float().abs().max().item()
    tol = 1e-4 * scale
    if dtype == torch.bfloat16:
        tol += 2.0 ** -8 * want.abs().max().item()
    err = (got.float() - want).abs().max().item()
    assert err <= tol, (label, variant, err, tol)
    assert torch.isfinite(got.float()).all()
    return got


DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                                 ids=["fp32", "bf16"])


@DTYPES
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_the_plain_version(card, case, dtype):
    (value, off, logits), ref, shapes = _inputs(case, dtype, card)
    _assert_matches(value, shapes, ref, off, logits, case)


def _random(B, Q, shapes, dtype, device, points=P, heads=H, spread=1.0,
            seed=23):
    """Random value, offsets (`spread` pixels) and logits in `dtype`, and
    reference points uniform over the maps."""
    S, L = sum(h * w for h, w in shapes), len(shapes)
    g = torch.Generator(device=device).manual_seed(seed)
    value = torch.randn(B, S, heads, DH, generator=g, device=device)
    ref = torch.rand(B, Q, L, 2, generator=g, device=device)
    off = spread * torch.randn(B, Q, heads, L, points, 2, generator=g,
                               device=device)
    logits = torch.randn(B, Q, heads, L * points, generator=g, device=device)
    return (value.to(dtype), shapes, ref, off.to(dtype), logits.to(dtype))


SMALL = [(8, 10), (4, 5)]
EDGE_B = 300  # enough blocks that the plan keeps its largest tile


@DTYPES
@pytest.mark.parametrize("at", ["one", "tile-1", "tile", "tile+1"])
def test_tile_edges(card, at, dtype):
    S = sum(h * w for h, w in SMALL)
    tile = _plan(EDGE_B, 8, S, H, len(SMALL), P, dtype).tile
    assert tile > 1
    Q = {"one": 1, "tile-1": tile - 1, "tile": tile, "tile+1": tile + 1}[at]
    _assert_matches(*_random(EDGE_B, Q, SMALL, dtype, card), at)


def _encoder(B, dtype, device):
    """An encoder layer's inputs at the cell's levels: a query a value row,
    its reference point its pixel's centre on every level, offsets of a
    few pixels."""
    S = sum(h * w for h, w in LEVELS)
    value, shapes, _, off, logits = _random(B, S, LEVELS, dtype, device,
                                            spread=2.0)
    centres = torch.cat([torch.stack(torch.meshgrid(
        (torch.arange(w, device=device) + 0.5) / w,
        (torch.arange(h, device=device) + 0.5) / h, indexing="xy"),
        -1).reshape(h * w, 2) for h, w in LEVELS])           # (S, 2)
    ref = centres[None, :, None].expand(B, S, len(LEVELS), 2).contiguous()
    return value, shapes, ref, off, logits


@DTYPES
@pytest.mark.parametrize("B", [1, 20])
def test_encoder_at_the_cells_shape(card, B, dtype):
    _assert_matches(*_encoder(B, dtype, card), f"encoder B={B}")


POW2 = [(8, 16), (4, 8)]


@DTYPES
def test_samples_on_a_maps_edges_and_wholly_outside(card, dtype):
    """Pixel coordinates (loc * size - 0.5) on every edge of each level,
    half a pixel and a whole pixel past it, and far off: ref 0 and
    offsets of whole and half pixels, exact in both versions."""
    B, L = 2, len(POW2)
    xs = [-3.0, -1.0, -0.5, 0.0, 0.5]
    pts = []
    for h, w in POW2:   # (x, y) of pixel coordinates, then offsets
        cols = xs + [w - 1.0, w - 0.5, w + 0.0, w + 2.0]
        rows = xs + [h - 1.0, h - 0.5, h + 0.0, h + 2.0]
        pts.append([(x, y) for x in cols for y in rows])
    Q = len(pts[0])
    off = torch.zeros(B, Q, H, L, P, 2, device=card)
    for l, level in enumerate(pts):
        xy = torch.tensor(level, device=card) + 0.5       # (Q, 2) pixels
        off[:, :, :, l] = xy[None, :, None, None, :]
    off[:, :, 1::2] = off[:, :, 1::2].flip(1)  # other heads, other places
    ref = torch.zeros(B, Q, L, 2, device=card)
    value, shapes, _, _, logits = _random(B, Q, POW2, dtype, card)
    got = _assert_matches(value, shapes, ref, off.to(dtype), logits,
                          "edges")
    outside = [i for i, (x, y) in enumerate(pts[0])
               if x <= -1 or y <= -1 or x >= POW2[0][1]
               or y >= POW2[0][0]]
    outside = [i for i in outside
               if pts[1][i][0] <= -1 or pts[1][i][1] <= -1
               or pts[1][i][0] >= POW2[1][1] or pts[1][i][1] >= POW2[1][0]]
    assert outside   # every corner of every level off the map: zeros
    assert (got.view(B, Q, H, DH)[:, outside, 0].float() == 0).all()


@DTYPES
@pytest.mark.parametrize("levels,points", [(1, 1), (1, 32), (2, 16),
                                           (3, 10), (4, 8)])
def test_levels_and_points(card, levels, points, dtype):
    shapes = [(37, 53), (19, 27), (10, 14), (5, 7)][:levels]
    _assert_matches(*_random(3, 211, shapes, dtype, card, points=points,
                             spread=3.0), f"{levels}x{points}")


@DTYPES
def test_a_captured_call_replays_bit_for_bit(card, dtype):
    value, shapes, ref, off, logits = _random(4, 300, LEVELS, dtype, card)
    variant = "bf16" if dtype == torch.bfloat16 else "fp32"
    with torch.no_grad():
        eager = ms_deform_attn(value, shapes, ref, off, logits)
        graph = cuda_graph.capture(
            lambda: ms_deform_attn(value, shapes, ref, off, logits), card)
        for _ in range(2):
            before = ms_deform_attn.variant_launches[variant]
            graph.replay()
            torch.cuda.synchronize()
            assert ms_deform_attn.variant_launches[variant] == before + 1
            assert torch.equal(graph.outputs, eager)


def test_a_call_with_grad_raises_and_training_takes_the_plain_op(card):
    from gpv_tpu_torch.nn.deformable_transformer import MSDeformAttn
    (value, off, logits), ref, shapes = _inputs("decoder", torch.float32,
                                                card)
    value.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        ms_deform_attn(value, shapes, ref, off, logits)
    layer = MSDeformAttn(H * DH, len(shapes), H, P).to(card)
    B, Q = ref.shape[:2]
    S = value.shape[1]
    query = torch.randn(B, Q, H * DH, device=card)
    before = dict(ms_deform_attn.variant_launches)
    out = layer(query, ref, torch.randn(B, S, H * DH, device=card), shapes,
                None, deterministic=False)
    out.sum().backward()
    assert ms_deform_attn.variant_launches == before
    assert layer.value_proj.weight.grad.abs().sum() > 0


def test_a_traced_program_launches_the_kernel(card):
    (value, off, logits), ref, shapes = _inputs("decoder", torch.bfloat16,
                                                card)

    class Sample(torch.nn.Module):
        def forward(self, value, ref, off, logits):
            return ms_deform_attn(value, shapes, ref, off, logits)

    prog = torch.export.export(Sample(), (value, ref, off, logits))
    before = ms_deform_attn.variant_launches["bf16"]
    with torch.no_grad():
        got = prog.module()(value, ref, off, logits)
        want = ms_deform_attn(value, shapes, ref, off, logits)
    assert ms_deform_attn.variant_launches["bf16"] == before + 2
    assert torch.equal(got, want)


def test_the_kernel_refuses_another_head_dim(card):
    (value, off, logits), ref, shapes = _inputs("decoder", torch.float32,
                                                card)
    B, S = value.shape[:2]
    wide = torch.randn(B, S, H // 2, 2 * DH, device=card)
    with torch.no_grad(), pytest.raises(ValueError, match="head dim 64"):
        ms_deform_attn(wide, shapes, ref, off[:, :, :H // 2].contiguous(),
                       logits[:, :, :H // 2].contiguous())
