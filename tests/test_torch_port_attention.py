"""K1/K2 of the PyTorch port against the Pallas kernels.

On the CPU the port's `fused_attention` / `fused_biattention` take their
plain versions; these are held against `gpv_tpu.ops.attention`'s Pallas
kernels in interpret mode on the same numpy inputs, mirroring every case of
tests/test_pallas.py, at atol 1e-5 in fp32 (both compute the same fp32
arithmetic; the slack covers summation order). The CUDA kernels themselves
are held against the plain versions in tests/test_torch_port_kernels.py.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from gpv_tpu.ops import attention as jax_attn
from gpv_tpu_torch.ops import attention as port_attn


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several workers at once: keep torch to one thread
    here, and give the next test file its setting back."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_mask(key_valid, causal, B, Tq, Tk):
    cm = (jnp.where(jnp.tril(jnp.ones((Tq, Tk), bool)), 0.0, -1e9)
          if causal else None)
    kv = None if key_valid is None else jnp.asarray(key_valid)
    return jax_attn.attention_mask(kv, cm, B, Tq, Tk)


def _check_k1(q, k, v, key_valid=None, causal=False, atol=1e-5,
              bf16=False):
    B, Tq = q.shape[:2]
    Tk = k.shape[1]
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    ref = jax_attn.fused_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        _jax_mask(key_valid, causal, B, Tq, Tk), interpret=True)
    kv = None if key_valid is None else torch.from_numpy(key_valid)
    got = port_attn.fused_attention(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
        torch.from_numpy(v).to(tdt), kv, causal)
    assert got.dtype == tdt and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=atol)


class TestFusedAttention:
    def test_parity_no_mask(self):
        rng = np.random.RandomState(0)
        q = rng.randn(2, 16, 4, 32).astype(np.float32)
        k = rng.randn(2, 24, 4, 32).astype(np.float32)
        v = rng.randn(2, 24, 4, 32).astype(np.float32)
        _check_k1(q, k, v)

    def test_parity_with_padding_and_causal(self):
        rng = np.random.RandomState(1)
        q = rng.randn(2, 8, 2, 16).astype(np.float32)
        key_valid = np.stack([[True] * 6 + [False] * 2, [True] * 8])
        _check_k1(q, q, q, key_valid, causal=True)

    @pytest.mark.parametrize("Dh", [32, 48, 64, 96])
    def test_head_dims_with_padding(self, Dh):
        rng = np.random.RandomState(Dh)
        q = rng.randn(2, 5, 3, Dh).astype(np.float32)
        k = rng.randn(2, 37, 3, Dh).astype(np.float32)
        v = rng.randn(2, 37, 3, Dh).astype(np.float32)
        key_valid = rng.rand(2, 37) > 0.3
        key_valid[:, 0] = True
        _check_k1(q, k, v, key_valid)

    def test_decode_step_shape(self):
        """Tq=1 against a 20-slot cache valid up to position t."""
        rng = np.random.RandomState(5)
        q = rng.randn(3, 1, 2, 96).astype(np.float32)
        k = rng.randn(3, 20, 2, 96).astype(np.float32)
        v = rng.randn(3, 20, 2, 96).astype(np.float32)
        key_valid = np.broadcast_to(np.arange(20) <= 6, (3, 20)).copy()
        _check_k1(q, k, v, key_valid)

    def test_bf16_rounds_p_like_pallas(self):
        rng = np.random.RandomState(6)
        q = rng.randn(2, 12, 2, 64).astype(np.float32)
        k = rng.randn(2, 12, 2, 64).astype(np.float32)
        _check_k1(q, k, k, causal=True, atol=1e-2, bf16=True)


class TestFusedBiAttention:
    @pytest.mark.parametrize("has1,has2", [(True, True), (False, False),
                                           (True, False), (False, True)])
    def test_parity_with_validity(self, has1, has2):
        rng = np.random.RandomState(3)
        B, T1, T2, H, Dh = 2, 6, 9, 4, 16
        xs = [rng.randn(B, T, H, Dh).astype(np.float32)
              for T in (T1, T1, T1, T2, T2, T2)]
        valid1 = np.stack([[True] * 4 + [False] * 2, [True] * 6])
        valid2 = rng.rand(B, T2) > 0.2
        valid2[:, 0] = True
        va = valid1 if has1 else None
        vb = valid2 if has2 else None
        r1, r2 = jax_attn.fused_biattention(
            *map(jnp.asarray, xs),
            None if va is None else jnp.asarray(va),
            None if vb is None else jnp.asarray(vb), interpret=True)
        c1, c2 = port_attn.fused_biattention(
            *map(torch.from_numpy, xs),
            None if va is None else torch.from_numpy(va),
            None if vb is None else torch.from_numpy(vb))
        assert c1.shape == (B, T2, H, Dh) and c2.shape == (B, T1, H, Dh)
        np.testing.assert_allclose(c1.numpy(), np.asarray(r1), atol=1e-5)
        np.testing.assert_allclose(c2.numpy(), np.asarray(r2), atol=1e-5)


def test_cpu_path_stays_differentiable():
    """The kernels are forward-only; on the CPU the plain versions run, so
    gradients flow (as the JAX einsum path keeps training differentiable
    beside the forward-only Pallas kernels)."""
    rng = np.random.RandomState(8)
    q = torch.from_numpy(rng.randn(2, 6, 4, 8).astype(np.float32))
    q.requires_grad_(True)
    out = port_attn.fused_attention(q, q, q, causal=True)
    c1, c2 = port_attn.fused_biattention(q, q, q, q, q, q)
    (out.square().sum() + c1.sum() + c2.sum()).backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
