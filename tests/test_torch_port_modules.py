"""Module parity of the PyTorch port against `gpv_tpu`, through the bridge.

Each `gpv_tpu` module is initialised at tiny widths, its variables go
through `gpv_tpu_torch.weights` into the port's counterpart, and both run
on the same numpy inputs in fp32 on the CPU. The JAX modules run their
default einsum attention, which masks invalid keys by replacement; the port
masks by adding -1e9 (as the Pallas kernels do). Every row here keeps a
valid key, where the two agree to fp32 precision. Tolerances: 1e-5 for
attention-only modules, 1e-4 (relative to the output scale) for deeper
stacks, where fp32 summation order and Flax's E[x^2]-E[x]^2 LayerNorm
variance add up.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gpv_tpu.models.detr import DETR as JDETR
from gpv_tpu.nn.bert import BertEncoder as JBert
from gpv_tpu.nn.coattention import CoAttentionLayer as JCoAtt
from gpv_tpu.nn.detr_transformer import DetrTransformer as JDetrTr
from gpv_tpu.nn.layers import MultiHeadAttention as JMHA
from gpv_tpu.nn.resnet import ResNet as JResNet
from gpv_tpu.nn.text_decoder import TextDecoder as JTextDec
from gpv_tpu.ops.fold_bn import fold_frozen_bn as jax_fold
from gpv_tpu.ops.posenc import sine_position_embedding_2d as jax_sine
from gpv_tpu.ops.posenc import sine_position_encoding_1d as jax_sine_1d
from gpv_tpu.ops.roi_align import roi_align_mean_pooled as jax_roi

from gpv_tpu_torch import weights as W
from gpv_tpu_torch.models.detr import DETR
from gpv_tpu_torch.nn.bert import BertEncoder
from gpv_tpu_torch.nn.coattention import CoAttentionLayer
from gpv_tpu_torch.nn.detr_transformer import DetrTransformer
from gpv_tpu_torch.nn.layers import MultiHeadAttention
from gpv_tpu_torch.nn.resnet import ResNet
from gpv_tpu_torch.nn.text_decoder import TextDecoder
from gpv_tpu_torch.ops.fold_bn import fold_frozen_bn
from gpv_tpu_torch.ops.posenc import (sine_position_embedding_2d,
                                      sine_position_encoding_1d)
from gpv_tpu_torch.ops.roi_align import roi_align_mean_pooled


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several workers at once: keep torch to one thread
    here, and give the next test file its setting back."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
KEY = jax.random.PRNGKey(0)
BLOCKS = (1, 1, 1, 1)


def close(got: torch.Tensor, ref, tol: float):
    ref = np.asarray(ref, np.float32)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got.detach().float().numpy(), ref,
                               atol=tol * scale, rtol=0)


def randomize_stats(stats, seed=0):
    """Frozen-BN statistics away from identity, so folding is exercised."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name = path[-1].key
        x = np.asarray(x)
        if name in ("weight", "running_var"):
            return (rng.rand(*x.shape) + 0.5).astype(np.float32)
        return (0.1 * rng.randn(*x.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, stats)


def load(module, sd):
    module.load_state_dict(sd, strict=True)
    return module.eval()


def test_mha():
    rng = np.random.RandomState(0)
    xq = rng.randn(2, 7, 32).astype(np.float32)
    xk = rng.randn(2, 11, 32).astype(np.float32)
    kv = rng.rand(2, 11) > 0.3
    kv[:, 0] = True
    jm = JMHA(32, 4, dropout=0.0)
    v = jm.init(KEY, xq, xk, xk)
    ref = jm.apply(v, xq, xk, xk, key_valid=jnp.asarray(kv))
    pm = load(MultiHeadAttention(32, 4), W.mha(v["params"]))
    got = pm(torch.from_numpy(xq), torch.from_numpy(xk),
             torch.from_numpy(xk), torch.from_numpy(kv))
    close(got, ref, 1e-5)


@pytest.mark.parametrize("folded,dilate", [(False, False), (True, False),
                                           (False, True)])
def test_resnet(folded, dilate):
    x = np.random.RandomState(1).randn(2, 48, 64, 3).astype(np.float32)
    jm = JResNet(layers=BLOCKS, dilate_c5=dilate)
    v = jax.jit(jm.init)(KEY, jnp.zeros((1, 48, 64, 3)))
    params, stats = v["params"], randomize_stats(v["batch_stats"])
    pm = load(ResNet(BLOCKS, dilate_c5=dilate), W.resnet(params, stats))
    if folded:
        params, stats = jax_fold(params, stats)
        fold_frozen_bn(pm)
    ref = jax.jit(jm.apply)({"params": params, "batch_stats": stats},
                            jnp.asarray(x))["layer4"]
    with torch.no_grad():
        got = pm(torch.from_numpy(x).permute(0, 3, 1, 2))
    close(got.permute(0, 2, 3, 1), ref, 1e-4)


def test_sine_position_encodings():
    valid = np.zeros((2, 6, 9), bool)
    valid[0, :5, :7] = True
    valid[1] = True
    close(sine_position_embedding_2d(torch.from_numpy(valid), 16),
          jax_sine(jnp.asarray(valid), num_pos_feats=16), 1e-5)
    close(sine_position_encoding_1d(768, 30),
          jax_sine_1d(768, 30), 1e-5)


@pytest.mark.parametrize("pre_norm", [False, True])
def test_detr_transformer(pre_norm):
    rng = np.random.RandomState(2)
    src = rng.randn(2, 12, 32).astype(np.float32)
    pos = rng.randn(2, 12, 32).astype(np.float32)
    qe = rng.randn(5, 32).astype(np.float32)
    kv = np.ones((2, 12), bool)
    kv[0, 9:] = False
    jm = JDetrTr(dim=32, num_heads=4, num_encoder_layers=2,
                 num_decoder_layers=2, ffn_dim=64, dropout=0.0,
                 pre_norm=pre_norm)
    v = jm.init(KEY, src, pos, qe, kv)
    hs, mem = jm.apply(v, src, pos, qe, jnp.asarray(kv))
    pm = load(DetrTransformer(32, 4, 2, 2, 64, pre_norm),
              W.detr_transformer(v["params"]))
    with torch.no_grad():
        got_hs, got_mem = pm(*map(torch.from_numpy, (src, pos, qe, kv)))
    close(got_hs, hs[-1], 1e-4)
    close(got_mem, mem, 1e-4)


def test_roi_align_mean_pooled():
    rng = np.random.RandomState(3)
    feats = rng.randn(2, 5, 7, 16).astype(np.float32)      # NHWC
    boxes = np.clip(rng.rand(2, 6, 4), 0.05, 0.95).astype(np.float32)
    boxes[0, 0] = [0.5, 0.5, 1.0, 1.0]   # whole image: grid capped at 8
    ref = jax_roi(jnp.asarray(feats), jnp.asarray(boxes))
    got = roi_align_mean_pooled(
        torch.from_numpy(feats).permute(0, 3, 1, 2), torch.from_numpy(boxes))
    close(got, ref, 1e-5)


def test_detr_with_image_valid():
    rng = np.random.RandomState(4)
    images = rng.randn(2, 48, 64, 3).astype(np.float32)
    valid = np.zeros((2, 48, 64), bool)
    valid[0, :40, :50] = True
    valid[1] = True
    cfg = dict(num_queries=10, hidden_dim=32, nheads=4,
               num_encoder_layers=2, num_decoder_layers=2,
               dim_feedforward=64, backbone_layers=BLOCKS)
    jm = JDETR(dropout=0.0, **cfg)
    v = jax.jit(jm.init)(KEY, jnp.zeros((1, 48, 64, 3)))
    v = {"params": v["params"],
         "batch_stats": randomize_stats(v["batch_stats"])}
    ref = jax.jit(jm.apply)(v, jnp.asarray(images), jnp.asarray(valid))
    pm = load(DETR(**cfg), W.detr(v["params"], v["batch_stats"]))
    with torch.no_grad():
        got = pm(torch.from_numpy(images), torch.from_numpy(valid))
    close(got["pred_boxes"], ref["pred_boxes"], 1e-4)
    close(got["pred_relevance_logits"], ref["pred_relevance_logits"], 1e-4)
    close(got["detr_hs"], ref["detr_hs"][-1], 1e-4)


def test_bert():
    rng = np.random.RandomState(5)
    ids = rng.randint(0, 100, (2, 9)).astype(np.int32)
    valid = np.ones((2, 9), bool)
    valid[0, 6:] = False
    jm = JBert(num_layers=2, hidden=32, heads=4, intermediate=128,
               vocab_size=100, max_len=16, dropout=0.0)
    v = jm.init(KEY, ids, valid)
    ref = jm.apply(v, jnp.asarray(ids), jnp.asarray(valid))
    pm = load(BertEncoder(2, 32, 4, 128, 100, 16), W.bert(v["params"]))
    with torch.no_grad():
        got = pm(torch.from_numpy(ids).long(), torch.from_numpy(valid))
    close(got, ref, 1e-4)


@pytest.mark.parametrize("with_valid", [False, True])
def test_co_attention(with_valid):
    rng = np.random.RandomState(6)
    x1 = rng.randn(2, 7, 32).astype(np.float32)
    x2 = rng.randn(2, 10, 32).astype(np.float32)
    valid1 = np.ones((2, 7), bool)
    valid1[1, 4:] = False
    va = jnp.asarray(valid1) if with_valid else None
    jm = JCoAtt(32, 4, 64, dropout=0.0)
    v = jm.init(KEY, x1, x2)
    r1, r2 = jm.apply(v, jnp.asarray(x1), jnp.asarray(x2), va, None)
    pm = load(CoAttentionLayer(32, 4, 64), W.co_attention_layer(v["params"]))
    with torch.no_grad():
        g1, g2 = pm(torch.from_numpy(x1), torch.from_numpy(x2),
                    torch.from_numpy(valid1) if with_valid else None, None)
    close(g1, r1, 1e-4)
    close(g2, r2, 1e-4)


def test_text_decoder_teacher_forced_and_stepwise():
    rng = np.random.RandomState(7)
    B, S, Tm = 2, 6, 9
    tgt = rng.randn(B, S, 32).astype(np.float32)
    memory = rng.randn(B, Tm, 32).astype(np.float32)
    mv = np.ones((B, Tm), bool)
    mv[0, 7:] = False
    jm = JTextDec(dim=32, num_heads=4, num_layers=2, ffn_dim=64,
                  dropout=0.0)
    v = jm.init(KEY, tgt, memory, mv)
    pm = load(TextDecoder(32, 4, 2, 64), W.text_decoder(v["params"]))
    mvj = jnp.asarray(mv)
    ref = jm.apply(v, jnp.asarray(tgt), jnp.asarray(memory), mvj)
    mvt = torch.from_numpy(mv)
    with torch.no_grad():
        close(pm(torch.from_numpy(tgt), torch.from_numpy(memory), mvt),
              ref, 1e-4)
        # stepwise: one token at a time against the static cache
        jkv = jm.apply(v, jnp.asarray(memory),
                       method=JTextDec.precompute_memory)
        jcache = jm.apply(v, B, S, method=JTextDec.init_cache)
        pkv = pm.precompute_memory(torch.from_numpy(memory))
        pcache = pm.init_cache(B, S, torch.float32, "cpu")
        for t in range(S):
            y, jcache = jm.apply(v, jnp.asarray(tgt[:, t:t + 1]), jkv, mvj,
                                 jcache, t, method=JTextDec.step)
            got = pm.step(torch.from_numpy(tgt[:, t:t + 1]), pkv, mvt,
                          pcache, t)
            close(got, y, 1e-4)
            close(got, ref[:, t:t + 1], 1e-4)
