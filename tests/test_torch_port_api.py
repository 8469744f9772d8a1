"""The public functions of `gpv_tpu` that the port's main paths do not
reach, against their JAX counterparts on the same numpy-seeded inputs, and
the port's headline workload `gpv_tpu_torch.bench` at tiny dims.

Tolerances: `resize_image` / `preprocess` 1e-5 (the port builds the
per-axis weights as `jax.image.scale_and_translate` does, fp32, and
contracts them in another order); `roi_align` 1e-5; the mask losses 1e-6;
`causal_mask`, `init_cache` and `skimage_read_semantics` exact (the same
arithmetic); `resnet50` and `detr_from_config` 1e-4 of the output's scale
(ResNet-50's depth of fp32 convolutions and Flax's LayerNorm variance, as
in tests/test_torch_port_modules.py), through the weight bridge.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gpv_tpu.data.skimage_resize import \
    skimage_read_semantics as jax_read_semantics
from gpv_tpu.decode.greedy import init_cache as jax_init_cache
from gpv_tpu.losses import criterion as jax_crit
from gpv_tpu.models.detr import detr_from_config as jax_detr_from_config
from gpv_tpu.models.gpv import build_gpv as jax_build_gpv
from gpv_tpu.nn.resnet import resnet50 as jax_resnet50
from gpv_tpu.nn.text_decoder import causal_mask as jax_causal_mask
from gpv_tpu.ops import image as jax_image
from gpv_tpu.ops.roi_align import roi_align as jax_roi_align
from gpv_tpu.utils.config import load_config as jax_load_config

import gpv_tpu_torch.models as port_models
import gpv_tpu_torch.nn as port_nn
import gpv_tpu_torch.ops as port_ops
from gpv_tpu_torch import weights as W
from gpv_tpu_torch.data.skimage_resize import skimage_read_semantics
from gpv_tpu_torch.decode.greedy import init_cache
from gpv_tpu_torch.losses import criterion as port_crit
from gpv_tpu_torch.models.gpv import build_gpv
from gpv_tpu_torch.utils.config import load_config
from gpv_tpu_torch.utils.profiling import trace

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _fake_data import TINY_OVERRIDES  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several workers at once: keep torch to one thread
    here, and give the next test file its setting back."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got: torch.Tensor, ref, tol: float):
    ref = np.asarray(ref, np.float32)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got.detach().float().numpy(), ref,
                               atol=tol * scale, rtol=0)


def randomize_stats(stats, seed=0):
    """Frozen-BN statistics away from identity."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        x = np.asarray(x)
        if path[-1].key in ("weight", "running_var"):
            return (rng.rand(*x.shape) + 0.5).astype(np.float32)
        return (0.1 * rng.randn(*x.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, stats)


# ---- ops/image.py

@pytest.mark.parametrize("shape,out,antialias", [
    ((2, 37, 53, 3), (24, 32), True),      # downscale both axes
    ((1, 20, 30, 3), (48, 64), True),      # upscale both axes
    ((37, 53, 3), (48, 32), True),         # one of each, unbatched
    ((2, 48, 53, 3), (48, 32), True),      # one axis kept as it is
    ((2, 37, 53, 3), (24, 32), False),     # plain linear
    ((1, 96, 128, 3), (480, 640), True)])  # bench.py's output size
def test_resize_image_matches_jax(shape, out, antialias):
    x = np.random.RandomState(sum(shape)).rand(*shape).astype(np.float32)
    ref = jax_image.resize_image(jnp.asarray(x), *out, antialias=antialias)
    got = port_ops.resize_image(torch.from_numpy(x), *out,
                                antialias=antialias)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("resize", [True, False])
def test_preprocess_matches_jax(resize):
    x = np.random.RandomState(7).randint(0, 256, (2, 33, 41, 3)).astype(
        np.uint8)
    ref = jax_image.preprocess(jnp.asarray(x), 24, 32, resize=resize)
    got = port_ops.preprocess(torch.from_numpy(x), 24, 32, resize=resize)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


# ---- ops/roi_align.py

def test_roi_align_matches_jax():
    rng = np.random.RandomState(3)
    feats = rng.randn(2, 5, 7, 16).astype(np.float32)      # NHWC
    boxes = np.clip(rng.rand(2, 6, 4), 0.05, 0.95).astype(np.float32)
    boxes[0, 0] = [0.5, 0.5, 1.0, 1.0]   # whole image: grid capped at 8
    ref = jax_roi_align(jnp.asarray(feats), jnp.asarray(boxes))
    got = port_ops.roi_align(torch.from_numpy(feats),
                             torch.from_numpy(boxes))
    assert tuple(got.shape) == (2, 6, 7, 7, 16)
    close(got, ref, 1e-5)
    # its bins average to what the DETR RoI head pools
    pooled = port_ops.roi_align_mean_pooled(
        torch.from_numpy(feats).permute(0, 3, 1, 2), torch.from_numpy(boxes))
    close(got.mean((2, 3)), pooled.numpy(), 1e-5)


# ---- models/detr.py, nn/resnet.py, nn/text_decoder.py

def _configs():
    return (load_config(ROOT / "configs", "exp/gpv", TINY_OVERRIDES),
            jax_load_config(str(ROOT / "configs"), "exp/gpv",
                            TINY_OVERRIDES))


def test_detr_from_config_matches_jax():
    """The tiny `model.detr` node (its ResNet-50 trunk as both functions
    take it) with the RoI head, through the weight bridge."""
    cfg, jcfg = _configs()
    images = np.random.RandomState(4).randn(2, 64, 64, 3).astype(np.float32)
    jm = jax_detr_from_config(jcfg.model.detr, roi_head=True)
    v = jax.jit(jm.init)(KEY, jnp.zeros((1, 64, 64, 3)))
    v = {"params": v["params"],
         "batch_stats": randomize_stats(v["batch_stats"])}
    ref = jax.jit(jm.apply)(v, jnp.asarray(images))
    pm = port_models.detr_from_config(cfg.model.detr, roi_head=True,
                                      device="cpu")
    pm.load_state_dict(W.detr(v["params"], v["batch_stats"]), strict=True)
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(images))
    assert pm.trunk.layer3.__len__() == 6  # ResNet-50, as in JAX
    close(got["pred_boxes"], ref["pred_boxes"], 1e-4)
    close(got["pred_relevance_logits"], ref["pred_relevance_logits"], 1e-4)
    close(got["detr_hs"], ref["detr_hs"][-1], 1e-4)


def test_resnet50_matches_jax():
    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    layers = ("layer1", "layer3", "layer4")
    jm = jax_resnet50(return_layers=layers)
    v = jax.jit(jm.init)(KEY, jnp.zeros((1, 64, 64, 3)))
    params, stats = v["params"], randomize_stats(v["batch_stats"])
    ref = jax.jit(jm.apply)({"params": params, "batch_stats": stats},
                            jnp.asarray(x))
    pm = port_nn.resnet50(return_layers=layers)
    pm.load_state_dict(W.resnet(params, stats), strict=True)
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert set(got) == set(ref) == set(layers)
    for name in layers:
        close(got[name].permute(0, 2, 3, 1), ref[name], 1e-4)


@pytest.mark.parametrize("T", [1, 5, 20])
def test_causal_mask_matches_jax(T):
    got = port_nn.causal_mask(T)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_causal_mask(T)))
    assert port_nn.causal_mask(T, torch.bfloat16).dtype == torch.bfloat16


# ---- decode/greedy.py

def test_init_cache_matches_jax():
    """One zero (K, V) pair a text-decoder layer, (batch, max_text_len,
    heads, head_dim), in the model's dtype (the tiny config: 1 layer of 4
    heads of 8)."""
    cfg, jcfg = _configs()
    jmodel = jax_build_gpv(jcfg.model, vocab_size=64)
    ref = jax_init_cache(jmodel, 3)
    got = init_cache(build_gpv(cfg.model, vocab_size=64), 3)
    assert len(got) == len(ref)
    for (k, v), (rk, rv) in zip(got, ref):
        for a, b in ((k, rk), (v, rv)):
            assert tuple(a.shape) == b.shape and a.dtype == torch.float32
            assert not a.any()


# ---- data/skimage_resize.py

@pytest.mark.parametrize("channels", [None, 3, 4])
def test_skimage_read_semantics_matches_jax(channels):
    """Grayscale (tiled to 3 channels), RGB and RGBA (alpha dropped)
    uint8 images resized exactly, float64: equal to the JAX package's."""
    rng = np.random.RandomState(channels or 1)
    shape = (37, 45) if channels is None else (37, 45, channels)
    img = rng.randint(0, 256, shape).astype(np.uint8)
    got = skimage_read_semantics(img, 24, 32)
    ref = jax_read_semantics(img, 24, 32)
    assert got.dtype == np.float64 and got.shape == (24, 32, 3)
    np.testing.assert_array_equal(got, ref)


# ---- losses/criterion.py

def test_mask_losses_match_jax():
    rng = np.random.RandomState(5)
    logits = (3 * rng.randn(4, 50)).astype(np.float32)
    targets = (rng.rand(4, 50) > 0.6).astype(np.float32)
    lt, tt = torch.from_numpy(logits), torch.from_numpy(targets)
    lj, tj = jnp.asarray(logits), jnp.asarray(targets)
    close(port_crit.optax_sigmoid_ce(lt, tt),
          jax_crit.optax_sigmoid_ce(lj, tj), 1e-6)
    for nb in (0.0, 3.0):
        close(port_crit.sigmoid_focal_loss(lt, tt, nb),
              jax_crit.sigmoid_focal_loss(lj, tj, nb), 1e-6)
        close(port_crit.sigmoid_focal_loss(lt, tt, nb, alpha=-1.0,
                                           gamma=1.5),
              jax_crit.sigmoid_focal_loss(lj, tj, nb, alpha=-1.0,
                                          gamma=1.5), 1e-6)
        close(port_crit.dice_loss(lt, tt, torch.tensor(nb)),
              jax_crit.dice_loss(lj, tj, nb), 1e-6)


# ---- utils/profiling.py

def test_trace_writes_a_trace_file(tmp_path):
    with trace(tmp_path / "prof"):
        torch.ones(8, 8).matmul(torch.ones(8, 8))
    path = tmp_path / "prof" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)


# ---- the exports, and the headline workload

def test_exports_match_the_jax_packages():
    import gpv_tpu.models as jm
    import gpv_tpu.nn as jn
    import gpv_tpu.ops as jo
    for name in ("resize_image", "preprocess", "normalize_image",
                 "roi_align", "roi_align_mean_pooled"):
        assert name in jo.__all__ and name in port_ops.__all__, name
    for name in ("resnet50", "causal_mask", "ResNet"):
        assert name in jn.__all__ and name in port_nn.__all__, name
    assert set(jm.__all__) == set(port_models.__all__)


@pytest.mark.parametrize("args", [[], ["mode=beam", "beam=3"]],
                         ids=["greedy", "beam"])
def test_bench_prints_one_line_with_bench_py_keys(args):
    """`python -m gpv_tpu_torch.bench device=cpu dims=tiny` (a fresh
    process, as a user runs it): exactly one JSON line with bench.py's
    keys plus the device and its power limit."""
    res = subprocess.run([sys.executable, "-m", "gpv_tpu_torch.bench",
                          "device=cpu", "dims=tiny", "batch=3", *args],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == {"metric", "value", "unit", "vs_baseline",
                         "baseline_estimated", "device", "power_limit_w"}
    assert line["metric"] == ("batched_beam3_inference_images_per_sec"
                              if args else
                              "batched_inference_images_per_sec")
    assert line["value"] > 0 and line["unit"] == "images/sec"
    assert line["baseline_estimated"] is True
    assert line["device"] == "cpu" and line["power_limit_w"] is None
