"""How the port's attention wrappers choose and size their kernels, on the
CPU (no launch): `_plan` routes each dtype and shape to the fp32, tile or
decode kernel with a block that fits the card, and `_aligned` refuses a
tensor whose data is not 16-byte aligned.

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


K1_CASES = _chip_smoke().k1_cases(19)


@pytest.mark.parametrize("case", K1_CASES, ids=lambda c: c[0])
def test_plan_routes_main_path_k1_shapes(case):
    name, _, tq, tk, _, dh, _, _, _ = case
    bf16 = A._plan(torch.bfloat16, tq, tk, dh)
    if tq == 1:
        assert bf16.variant == "decode"
        assert bf16.warps == min(4, -(-tk // 32))
    else:
        assert bf16.variant == "tile"
        assert bf16.warps == min(4, -(-tq // 16))
        assert bf16.key_tile == 64
    assert A._plan(torch.float32, tq, tk, dh).variant == "fp32"


def test_plan_routes_k2_to_the_tile_kernel():
    plan = A._plan(torch.bfloat16, 100, 20, 48, both=True)
    assert plan == A.Plan("tile", 4, 64, plan.smem_bytes)
    # one-row streams stay on the tile kernel: K2 has no decode variant
    assert A._plan(torch.bfloat16, 1, 1, 48, both=True).variant == "tile"
    assert A._plan(torch.float32, 100, 20, 48, both=True).variant == "fp32"


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
    with pytest.raises(ValueError, match="multiples of 8"):
        A._plan(torch.bfloat16, 4, 4, 12)
    with pytest.raises(ValueError, match="multiples of 8"):
        A._plan(torch.bfloat16, 4, 4, 136)
    with pytest.raises(TypeError, match="not supported"):
        A._plan(torch.float16, 4, 4, 32)


def test_alignment_check_refuses_a_view_one_element_in():
    storage = torch.zeros(2, 9, 2, 8, dtype=torch.bfloat16)
    flat = storage.view(-1)
    assert storage.data_ptr() % 16 == 0
    A._aligned("fused_attention", {"q": storage, "k": flat[8:]})
    with pytest.raises(ValueError, match="2 bytes past a 16-byte boundary"):
        A._aligned("fused_attention", {"q": storage, "k": flat[1:]})
