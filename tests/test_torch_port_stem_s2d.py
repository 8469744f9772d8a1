"""The space-to-depth stem in the port (`gpv_tpu_torch/ops/stem_s2d.py`,
`model.detr.stem_s2d`): the cases of tests/test_stem_s2d.py against the
JAX functions, the weight bridge of an s2d tree, the composition with the
serving BN fold, and a predict against the JAX s2d engine.

The rewrite is exact up to float reassociation: conv outputs 1e-5, the
whole tower 1e-4 (tests/test_stem_s2d.py's tolerances), the engine at the
slice's parity tolerances (answers equal, boxes 2e-4, relevance 5e-4).
"""
import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from gpv_tpu.engine import GPVEngine as JaxEngine
from gpv_tpu.models.gpv import GPV as JaxGPV
from gpv_tpu.nn.resnet import ResNet as JaxResNet
from gpv_tpu.ops import stem_s2d as J
from gpv_tpu.text.vocab import AnswerVocab as JaxVocab
from gpv_tpu.text.wordpiece import WordPieceTokenizer as JaxTok
from gpv_tpu.train.checkpoint import convert_gpv_torch

from gpv_tpu_torch.engine import STEM, GPVEngine
from gpv_tpu_torch.models.gpv import GPV, build_gpv
from gpv_tpu_torch.nn.resnet import ResNet
from gpv_tpu_torch.ops import stem_s2d as P
from gpv_tpu_torch.ops.fold_bn import fold_frozen_bn
from gpv_tpu_torch.text.vocab import AnswerVocab
from gpv_tpu_torch.text.wordpiece import WordPieceTokenizer
from gpv_tpu_torch.utils.config import load_config
from gpv_tpu_torch.weights import init_random, state_dict_from_jax

from _fake_data import TINY_OVERRIDES

VOCAB, D, H, W = 40, 32, 48, 64
BLOCKS = (1, 1, 1, 1)
DETR_CFG = dict(num_queries=10, num_classes=1, hidden_dim=D, nheads=4,
                num_encoder_layers=1, num_decoder_layers=1,
                dim_feedforward=64, backbone_layers=BLOCKS)
ARGS = dict(vocab_size=VOCAB, hidden_dim=D, max_text_len=8,
            co_att_num_layers=1, co_att_heads=4, co_att_intermediate=64,
            text_decoder_layers=1, text_decoder_heads=4, bert_layers=1,
            bert_hidden=D, bert_heads=4, bert_vocab_size=100,
            bert_max_len=16)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nchw(x_nhwc):
    return torch.from_numpy(np.ascontiguousarray(x_nhwc)).permute(0, 3, 1, 2)


class TestKernelRewrite:
    def test_conv_equivalence(self):
        """conv7x7/s2/pad3 == conv4x4/s1/pad(2,1) over s2d input, and the
        port's output equals the JAX rewrite's on the same input."""
        rng = np.random.RandomState(0)
        x = rng.randn(2, 24, 32, 3).astype(np.float32)
        k7 = rng.randn(16, 3, 7, 7).astype(np.float32)  # OIHW
        xt, kt = _nchw(x), torch.from_numpy(k7)
        ref = F.conv2d(xt, kt, stride=2, padding=3)
        got = F.conv2d(F.pad(P.space_to_depth(xt), P.STEM_PAD),
                       P.s2d_stem_kernel(kt))
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5,
                                   rtol=1e-5)
        want = jax.lax.conv_general_dilated(
            J.space_to_depth(jnp.asarray(x)),
            jnp.asarray(J.s2d_stem_kernel(k7.transpose(2, 3, 1, 0))),
            (1, 1), [(2, 1), (2, 1)],
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), atol=1e-5, rtol=1e-5)

    def test_kernel_and_layout_equal_the_jax_rewrite(self):
        """Same tap map: the port's OIHW kernel is the JAX HWIO kernel
        transposed, and space_to_depth's channel order is the JAX one."""
        k7 = np.arange(7 * 7 * 3 * 2, dtype=np.float64).reshape(7, 7, 3, 2)
        k7 += 1.0  # no zero entries in the source
        want = J.s2d_stem_kernel(k7)
        got = P.s2d_stem_kernel(torch.from_numpy(k7.transpose(3, 2, 0, 1)))
        np.testing.assert_array_equal(got.numpy().transpose(2, 3, 1, 0),
                                      want)
        x = np.random.RandomState(1).randn(2, 6, 8, 3).astype(np.float32)
        np.testing.assert_array_equal(
            P.space_to_depth(_nchw(x)).permute(0, 2, 3, 1).numpy(),
            np.asarray(J.space_to_depth(jnp.asarray(x))))

    def test_zero_taps_only_at_leading_edge(self):
        k7 = torch.arange(2 * 3 * 7 * 7, dtype=torch.float64).reshape(
            2, 3, 7, 7) + 1.0
        kb = P.s2d_stem_kernel(k7)
        assert kb.shape == (2, 12, 4, 4)
        assert int((kb[0] != 0).sum()) == 7 * 7 * 3
        assert sorted(kb[0][kb[0] != 0].tolist()) == sorted(
            k7[0].flatten().tolist())

    def test_rejects_non_stem_kernel(self):
        with pytest.raises(ValueError, match="7x7"):
            P.s2d_stem_kernel(torch.zeros(64, 64, 1, 1))

    def test_space_to_depth_rejects_odd(self):
        with pytest.raises(ValueError, match="even"):
            P.space_to_depth(torch.zeros(1, 3, 7, 8))


def _stats(model, seed=1):
    """Randomise the frozen-BN statistics so parity covers them."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, b in model.named_buffers():
            if name.endswith(("weight", "running_var")):
                b.copy_(torch.rand(b.shape, generator=g) + 0.5)
            elif name.endswith(("bias", "running_mean")):
                b.copy_(0.1 * torch.randn(b.shape, generator=g))
    return model


class TestResNetParity:
    def test_full_tower_parity_and_state_dict_transform(self):
        """A ResNet built with stem_s2d over apply_stem_s2d(state dict)
        matches the plain tower and the JAX s2d tower on the same weights;
        the bottlenecks' 1x1 conv1 kernels are untouched."""
        x = np.random.RandomState(1).randn(2, 32, 48, 3).astype(np.float32)
        plain = _stats(init_random(ResNet(BLOCKS), 0)).eval()
        s2d = ResNet(BLOCKS, stem_s2d=True).eval()
        sd = P.apply_stem_s2d(plain.state_dict())
        s2d.load_state_dict(sd, strict=True)
        with torch.no_grad():
            ref, got = plain(_nchw(x)), s2d(_nchw(x))
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4,
                                   rtol=1e-4)
        assert tuple(sd["conv1.weight"].shape) == tuple(
            s2d.conv1.weight.shape) == (64, 12, 4, 4)
        assert torch.equal(sd["layer1.0.conv1.weight"],
                           plain.state_dict()["layer1.0.conv1.weight"])

        jr = JaxResNet(layers=BLOCKS, stem_s2d=True)
        tree = convert_gpv_torch(
            {f"detr.backbone.0.body.{k}": v.numpy()
             for k, v in plain.state_dict().items()} | _rest_of_gpv(),
            num_co_att=1, text_dec_layers=1, hidden=D, detr_layers=BLOCKS,
            detr_dim=D, detr_enc=1, detr_dec=1, bert_layers=1)
        bb = {"params": J.apply_stem_s2d(tree["params"]["detr"]["backbone"]),
              "batch_stats": tree["batch_stats"]["detr"]["backbone"]}
        want = jr.apply(bb, jnp.asarray(x))["layer4"]
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), atol=1e-4, rtol=1e-4)

    def test_transform_requires_a_stem(self):
        with pytest.raises(ValueError, match="no 7x7"):
            P.apply_stem_s2d({"dense.weight": torch.zeros(8, 8)})

    @pytest.mark.parametrize("fold_first", [False, True])
    def test_composes_with_the_bn_fold_in_either_order(self, fold_first):
        x = _nchw(np.random.RandomState(2).randn(2, 32, 48, 3)
                  .astype(np.float32))
        plain = _stats(init_random(ResNet(BLOCKS), 0)).eval()
        with torch.no_grad():
            ref = plain(x)
        s2d = ResNet(BLOCKS, stem_s2d=True).eval()
        if fold_first:
            folded = fold_frozen_bn(copy.deepcopy(plain))
            fold_frozen_bn(s2d)
            s2d.load_state_dict(P.apply_stem_s2d(folded.state_dict()),
                                strict=True)
        else:
            s2d.load_state_dict(P.apply_stem_s2d(plain.state_dict()),
                                strict=True)
            fold_frozen_bn(s2d)
        with torch.no_grad():
            got = s2d(x)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4,
                                   rtol=1e-4)

    def test_seeded_init_draws_the_plain_stem_rewritten(self):
        plain = init_random(ResNet(BLOCKS), 3)
        s2d = init_random(ResNet(BLOCKS, stem_s2d=True), 3)
        want = P.apply_stem_s2d(plain.state_dict())
        for k, v in s2d.state_dict().items():
            assert torch.equal(v, want[k]), k


def _rest_of_gpv():
    """The non-backbone entries of a tiny GPV state dict, so the JAX
    converter (which takes a whole GPV) can be used for the backbone."""
    sd = init_random(GPV(detr_cfg=DETR_CFG, **ARGS), 0).state_dict()
    return {k: v.numpy() for k, v in sd.items()
            if not k.startswith("detr.backbone.0.body.")}


class TestConfigAndBridge:
    def test_build_gpv_forwards_stem_s2d(self):
        cfg = load_config("configs", "exp/gpv",
                          TINY_OVERRIDES + ["model.detr.stem_s2d=true"])
        assert build_gpv(cfg.model, 50).detr.trunk.stem_s2d
        cfg0 = load_config("configs", "exp/gpv", TINY_OVERRIDES)
        assert not build_gpv(cfg0.model, 50).detr.trunk.stem_s2d

    def test_weight_bridge_maps_an_s2d_tree_and_inverts_exactly(self):
        jm = JaxGPV(dropout=0.0, detr_cfg=dict(DETR_CFG, dropout=0.0,
                                               stem_s2d=True), **ARGS)
        v = jax.jit(lambda k: jm.init(k, jnp.zeros((1, H, W, 3)),
                                      jnp.zeros((1, 5), jnp.int32),
                                      jnp.zeros((1, 8), jnp.int32)))(
            jax.random.PRNGKey(0))
        v = jax.tree.map(np.asarray, dict(v))
        assert v["params"]["detr"]["backbone"]["conv1"]["kernel"].shape == (
            4, 4, 12, 64)
        sd = state_dict_from_jax(v)
        assert tuple(sd[STEM].shape) == (64, 12, 4, 4)
        pm = GPV(detr_cfg=dict(DETR_CFG, stem_s2d=True), **ARGS)
        pm.load_state_dict(sd, strict=True)
        back = convert_gpv_torch(
            {k: t.numpy() for k, t in pm.state_dict().items()},
            num_co_att=1, text_dec_layers=1, hidden=D, detr_layers=BLOCKS,
            detr_dim=D, detr_enc=1, detr_dec=1, bert_layers=1)
        want = jax.tree_util.tree_leaves_with_path(v)
        got = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(got) == len(want)
        for path, leaf in want:
            np.testing.assert_array_equal(got[path], leaf,
                                          err_msg=jax.tree_util.keystr(path))


def test_predict_matches_the_jax_s2d_engine():
    """The port's engine with `stem_s2d` from the plain (7x7) weights
    (`GPVEngine.from_config` rewrites the stem) against the JAX engine over
    an s2d model with `apply_stem_s2d` params, and against the port's
    plain engine."""
    jm = JaxGPV(dropout=0.0, detr_cfg=dict(DETR_CFG, dropout=0.0), **ARGS)
    v = jax.jit(lambda k: jm.init(k, jnp.zeros((1, H, W, 3)),
                                  jnp.zeros((1, 5), jnp.int32),
                                  jnp.zeros((1, 8), jnp.int32)))(
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    v = {"params": jax.tree.map(np.asarray, v["params"]),
         "batch_stats": jax.tree.map(
             lambda x: (rng.rand(*np.shape(x)) + 0.5).astype(np.float32),
             v["batch_stats"])}
    js2d = jm.clone(detr_cfg=dict(DETR_CFG, dropout=0.0, stem_s2d=True))
    jax_eng = JaxEngine(js2d, None, JaxVocab.debug(size=VOCAB),
                        JaxTok.debug(), max_query_len=8)
    jax_eng.variables = {"params": J.apply_stem_s2d(v["params"]),
                         "batch_stats": v["batch_stats"]}

    sd = state_dict_from_jax(v)
    kw = dict(dtype=torch.float32, device="cpu", max_query_len=8)
    vocab, tok = AnswerVocab.debug(size=VOCAB), WordPieceTokenizer.debug()

    def engine(s2d):
        return GPVEngine(_port_gpv(s2d, sd), vocab, tok, **kw)

    port_s2d, port_plain = engine(True), engine(False)
    assert port_s2d.model.detr.trunk.stem_s2d
    images = rng.randint(0, 255, (3, H, W, 3)).astype(np.uint8)
    queries = ["what is the man riding?", "dog", "a cat on a mat"]
    want = jax_eng.predict(images, queries)
    for other in (want, port_plain.predict(images, queries)):
        for g, r in zip(port_s2d.predict(images, queries), other):
            assert g["answer"] == r["answer"]
            np.testing.assert_allclose(g["boxes"], r["boxes"], atol=2e-4,
                                       rtol=0)
            np.testing.assert_allclose(g["relevance"], r["relevance"],
                                       atol=5e-4, rtol=0)


def test_from_config_rewrites_a_plain_stem():
    """`GPVEngine.from_config` (what build_engine calls) loads a plain
    (7x7) state dict into an s2d model by rewriting its stem: the s2d
    engine answers as the plain one."""
    plain_cfg = load_config("configs", "exp/gpv_inference", TINY_OVERRIDES)
    s2d_cfg = load_config("configs", "exp/gpv_inference",
                          TINY_OVERRIDES + ["model.detr.stem_s2d=true"])
    vocab, tok = AnswerVocab.debug(size=VOCAB), WordPieceTokenizer.debug()
    sd = init_random(build_gpv(plain_cfg.model, VOCAB), 4).state_dict()
    assert sd[STEM].shape[-1] == 7
    kw = dict(dtype=torch.float32, device="cpu")
    plain = GPVEngine.from_config(plain_cfg.model, vocab, tok, sd, **kw)
    s2d = GPVEngine.from_config(s2d_cfg.model, vocab, tok, sd, **kw)
    assert s2d.model.detr.trunk.stem_s2d
    images = np.random.RandomState(6).randint(0, 255, (2, H, W, 3),
                                              np.uint8)
    for g, r in zip(s2d.predict(images, ["dog", "what is it?"]),
                    plain.predict(images, ["dog", "what is it?"])):
        assert g["answer"] == r["answer"]
        np.testing.assert_allclose(g["boxes"], r["boxes"], atol=2e-4, rtol=0)
        np.testing.assert_allclose(g["relevance"], r["relevance"],
                                   atol=5e-4, rtol=0)


def _port_gpv(s2d, sd):
    """The tiny port GPV with the plain weights `sd`, its stem rewritten
    when `s2d` (what `GPVEngine.from_config` does with a 7x7 state dict)."""
    pm = GPV(detr_cfg=dict(DETR_CFG, stem_s2d=s2d), **ARGS)
    pm.load_state_dict(P.apply_stem_s2d(sd) if s2d else sd, strict=True)
    return pm
