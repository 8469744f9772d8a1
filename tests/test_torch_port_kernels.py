"""The port's CUDA kernels K1/K2 against their plain PyTorch versions.

Card only: every test here is marked `cuda` and skips without a CUDA
device. The file imports neither JAX nor the JAX package, so it runs on a
machine with PyTorch alone:

    python -m pytest --noconftest -m cuda tests/test_torch_port_kernels.py

Shapes are the main path's (DETR 300x300 / 100x100 / 100x300 with Dh 32,
BERT 20x20 Dh 64, decode step 1x20 and 1x120 Dh 96, co-attention 20 x 100
with 16 heads of 48), then ragged ones for each kernel variant (fp32; bf16
tile for Tq >= 2 and K2; bf16 decode for Tq = 1): Tq in {1, 17, 65}, Tk in
{1, 33, 301}, each Dh in {32, 48, 64, 96}, causal, and a fully masked row;
and beam search's shapes: Tq = K in {1, 3, 5, 20} beams over the 120-slot
memory, and 3 to 100 beam rows (B·K) over the 20-slot cache.
Tolerance: fp32 1e-5, bf16 2e-2, both times max(1, max |plain|); fp32 runs
with TF32 off.
"""
import pytest
import torch

from gpv_tpu_torch.ops import attention as port_attn


DTYPES = [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)]


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,Tq,Tk,H,Dh,masked,causal", [
    (2, 300, 300, 8, 32, True, False),   # DETR encoder self
    (2, 100, 300, 8, 32, True, False),   # DETR decoder cross
    (2, 20, 20, 12, 64, True, False),    # BERT
    (2, 1, 20, 8, 96, True, False),      # decode step, cache
    (2, 1, 120, 8, 96, True, False),     # decode step, memory
    (2, 20, 20, 8, 96, False, True),     # teacher-forced causal
])
def test_k1_kernel_matches_plain(dtype, tol, B, Tq, Tk, H, Dh, masked,
                                 causal):
    _cuda_or_skip()
    g = torch.Generator(device="cuda").manual_seed(0)
    mk = lambda T: torch.randn(B, T, H, Dh, device="cuda",  # noqa: E731
                               generator=g).to(dtype)
    q, k, v = mk(Tq), mk(Tk), mk(Tk)
    kv = None
    if masked:
        kv = torch.rand(B, Tk, device="cuda", generator=g) > 0.3
        kv[:, 0] = True
    got = port_attn.fused_attention(q, k, v, kv, causal)
    ref = port_attn.attend_plain(q, k, v, kv, causal)
    torch.cuda.synchronize()
    scale = max(1.0, ref.float().abs().max().item())
    assert (got.float() - ref.float()).abs().max().item() <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("has1,has2", [(True, True), (False, False),
                                       (True, False), (False, True)])
def test_k2_kernel_matches_plain(dtype, tol, has1, has2):
    _cuda_or_skip()
    B, T1, T2, H, Dh = 2, 20, 100, 16, 48
    g = torch.Generator(device="cuda").manual_seed(1)
    xs = [torch.randn(B, T, H, Dh, device="cuda", generator=g).to(dtype)
          for T in (T1, T1, T1, T2, T2, T2)]
    v1 = torch.rand(B, T1, device="cuda", generator=g) > 0.3 if has1 else None
    v2 = torch.rand(B, T2, device="cuda", generator=g) > 0.3 if has2 else None
    for v in (v1, v2):
        if v is not None:
            v[:, 0] = True
    got = port_attn.fused_biattention(*xs, v1, v2)
    ref = port_attn.biattend_plain(*xs, v1, v2)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        scale = max(1.0, b.float().abs().max().item())
        assert (a.float() - b.float()).abs().max().item() <= tol * scale


@pytest.mark.cuda
def test_kernels_are_forward_only():
    _cuda_or_skip()
    q = torch.randn(1, 4, 2, 32, device="cuda", requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        port_attn.fused_attention(q, q, q)
    with pytest.raises(RuntimeError, match="forward-only"):
        port_attn.fused_biattention(q, q, q, q, q, q)
    with torch.no_grad():
        port_attn.fused_attention(q, q, q)


def _k1_against_plain(dtype, tol, B, Tq, Tk, H, Dh, causal=False):
    """One K1 call on random inputs with random key validity (the first
    key valid): it must take the kernel `_plan` names and match the plain
    version."""
    g = torch.Generator(device="cuda").manual_seed(0)
    mk = lambda T: torch.randn(B, T, H, Dh, device="cuda",  # noqa: E731
                               generator=g).to(dtype)
    q, k, v = mk(Tq), mk(Tk), mk(Tk)
    kv = torch.rand(B, Tk, device="cuda", generator=g) > 0.3
    kv[:, 0] = True
    launches = dict(port_attn.fused_attention.variant_launches)
    got = port_attn.fused_attention(q, k, v, kv, causal)
    ref = port_attn.attend_plain(q, k, v, kv, causal)
    torch.cuda.synchronize()
    variant = port_attn._plan(dtype, Tq, Tk, Dh).variant
    assert port_attn.fused_attention.variant_launches[variant] == \
        launches[variant] + 1
    scale = max(1.0, ref.float().abs().max().item())
    assert (got.float() - ref.float()).abs().max().item() <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("Tq", [1, 17, 65])
@pytest.mark.parametrize("Tk", [1, 33, 301])
def test_k1_ragged_shapes_match_plain(dtype, tol, Tq, Tk):
    _cuda_or_skip()
    _k1_against_plain(dtype, tol, 2, Tq, Tk, 3, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("Dh", [32, 48, 64, 96])
@pytest.mark.parametrize("Tq", [1, 40])
def test_k1_head_dims_match_plain(dtype, tol, Dh, Tq):
    _cuda_or_skip()
    _k1_against_plain(dtype, tol, 2, Tq, 77, 4, Dh)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("T", [1, 17, 65])
def test_k1_causal_matches_plain(dtype, tol, T):
    _cuda_or_skip()
    _k1_against_plain(dtype, tol, 2, T, T, 3, 48, causal=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("Tq", [1, 17])
def test_k1_fully_masked_row_is_the_uniform_average(dtype, tol, Tq):
    """Every key of batch row 0 invalid: each score is s - 1e9, which is
    -1e9 in fp32, so softmax is uniform and the output is V's mean, as the
    plain version (and the Pallas cell) gives it."""
    _cuda_or_skip()
    B, Tk, H, Dh = 2, 45, 3, 32
    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn(B, T, H, Dh, device="cuda", generator=g)
               .to(dtype) for T in (Tq, Tk, Tk))
    kv = torch.ones(B, Tk, dtype=torch.bool, device="cuda")
    kv[0] = False
    got = port_attn.fused_attention(q, k, v, kv)
    ref = port_attn.attend_plain(q, k, v, kv)
    mean = v[0].float().mean(0).expand(Tq, H, Dh)
    torch.cuda.synchronize()
    assert (got.float() - ref.float()).abs().max().item() <= tol
    assert (got[0].float() - mean).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("T1,T2", [(17, 65), (1, 33), (65, 1)])
def test_k2_ragged_shapes_match_plain(dtype, tol, T1, T2):
    _cuda_or_skip()
    B, H, Dh = 2, 4, 48
    g = torch.Generator(device="cuda").manual_seed(2)
    xs = [torch.randn(B, T, H, Dh, device="cuda", generator=g).to(dtype)
          for T in (T1, T1, T1, T2, T2, T2)]
    v1 = torch.rand(B, T1, device="cuda", generator=g) > 0.3
    v2 = torch.rand(B, T2, device="cuda", generator=g) > 0.3
    v1[:, 0] = v2[:, 0] = True
    got = port_attn.fused_biattention(*xs, v1, v2)
    ref = port_attn.biattend_plain(*xs, v1, v2)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        scale = max(1.0, b.float().abs().max().item())
        assert (a.float() - b.float()).abs().max().item() <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("K", [1, 3, 5, 20])
def test_k1_beam_grouped_cross_attention_matches_plain(dtype, tol, K):
    """predict_beam's cross-attention: the K beams of each of 4 samples as
    K query rows over the 120-slot memory (Dh 96) with its key mask."""
    _cuda_or_skip()
    _k1_against_plain(dtype, tol, 4, K, 120, 8, 96)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("rows", [3, 20, 24, 100])
def test_k1_beam_cache_step_matches_plain(dtype, tol, rows):
    """predict_beam's self-attention step: B·K beam rows (B=20, K=5; the
    server's K=3 at buckets 1 and 8) each one query over the 20-slot
    cache."""
    _cuda_or_skip()
    _k1_against_plain(dtype, tol, rows, 1, 20, 8, 96)


@pytest.mark.cuda
def test_misaligned_view_is_refused():
    _cuda_or_skip()
    flat = torch.randn(2 * 9 * 2 * 8 + 1, device="cuda").to(torch.bfloat16)
    q = flat[1:].view(2, 9, 2, 8)  # contiguous, 2 bytes off the boundary
    with torch.no_grad(), pytest.raises(ValueError, match="16-byte"):
        port_attn.fused_attention(q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Tq", [1, 20])
def test_torch_ops_equal_the_direct_wrappers(dtype, Tq):
    """`torch.ops.gpv.*` (what exported programs call) on the card: bit
    for bit the direct wrapper's result, and one launch counted a call."""
    _cuda_or_skip()
    g = torch.Generator(device="cuda").manual_seed(4)
    mk = lambda T, H, Dh: torch.randn(2, T, H, Dh, device="cuda",  # noqa
                                      generator=g).to(dtype)
    q, k, v = mk(Tq, 8, 96), mk(20, 8, 96), mk(20, 8, 96)
    kv = torch.arange(20, device="cuda").expand(2, 20) < 12
    with torch.inference_mode():
        want = port_attn.fused_attention(q, k, v, kv.contiguous(), False)
        n = port_attn.fused_attention.launches
        got = torch.ops.gpv.fused_attention(q, k, v, kv.contiguous(), False)
        assert port_attn.fused_attention.launches == n + 1
        assert torch.equal(got, want)
        xs = [mk(T, 16, 48) for T in (20, 20, 20, 100, 100, 100)]
        want2 = port_attn.fused_biattention(*xs, kv.contiguous(), None)
        n = port_attn.fused_biattention.launches
        got2 = torch.ops.gpv.fused_biattention(*xs, kv.contiguous(), None)
        assert port_attn.fused_biattention.launches == n + 1
        assert all(torch.equal(a, b) for a, b in zip(got2, want2))
