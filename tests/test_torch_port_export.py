"""The port's serving bundles on the CPU: K1 and K2 as torch ops,
`export_engine` / `ExportedEngine` against `GPVEngine.predict` and against
`gpv_tpu.export.ExportedEngine` on the same fp32 weights, a bundle loaded
without the model code, `serve_http bundle=` end to end, and the export
CLI.
"""
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gpv_tpu.engine import GPVEngine as JaxEngine
from gpv_tpu.export import ExportedEngine as JaxExportedEngine
from gpv_tpu.export import export_engine as jax_export_engine
from gpv_tpu.models.gpv import build_gpv as jax_build_gpv
from gpv_tpu.text.vocab import AnswerVocab as JaxVocab
from gpv_tpu.text.wordpiece import WordPieceTokenizer as JaxTok
from gpv_tpu.utils.config import load_config as jax_load_config

from gpv_tpu_torch.cli import export_serving
from gpv_tpu_torch.decode.greedy import greedy_decode
from gpv_tpu_torch.engine import encode_sorted
from gpv_tpu_torch.export import ExportedEngine, export_engine
from gpv_tpu_torch.infer.build import build_engine
from gpv_tpu_torch.ops import _cuda
from gpv_tpu_torch.ops import attention as A
from gpv_tpu_torch.utils.config import load_config
from gpv_tpu_torch.weights import state_dict_from_jax

from _fake_data import IMG_H, IMG_W, TINY_OVERRIDES
from test_torch_port_config import _random_batch_stats

ROOT = Path(__file__).resolve().parent.parent
BOX_TOL, REL_TOL = 2e-4, 5e-4  # ROADMAP's JAX parity tolerances
BUCKETS = (1, 3)
QUERIES = ["what is this?", "a dog", "the man on the left"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _overrides():
    return ["task_configs.image_size={H: %d, W: %d}" % (IMG_H, IMG_W)
            ] + TINY_OVERRIDES


@pytest.fixture(scope="module")
def bridge(tmp_path_factory):
    """(JAX engine, .pth of its variables, fp32 port engine from it)."""
    cfg = jax_load_config(ROOT / "configs", "exp/gpv", _overrides())
    vocab = JaxVocab.debug()
    model = jax_build_gpv(cfg.model, vocab_size=len(vocab))
    variables = jax.jit(lambda k: model.init(
        k, jnp.zeros((1, IMG_H, IMG_W, 3)), jnp.zeros((1, 5), jnp.int32),
        jnp.zeros((1, 4), jnp.int32)))(jax.random.PRNGKey(3))
    variables = _random_batch_stats(variables, seed=1)
    path = tmp_path_factory.mktemp("ckpt") / "model.pth"
    torch.save({"model": {f"module.{k}": v for k, v in
                          state_dict_from_jax(variables).items()}}, path)
    engine = build_engine(load_config(
        ROOT / "configs", "exp/gpv", _overrides()
        + [f"ckpt={path}", "device=cpu", "tpu.dtype=float32"]))
    return JaxEngine(model, variables, vocab, JaxTok.debug()), path, engine


@pytest.fixture(scope="module")
def bundle(bridge, tmp_path_factory):
    out = tmp_path_factory.mktemp("bundle")
    manifest = export_engine(bridge[2], out, batch_sizes=BUCKETS,
                             image_hw=(IMG_H, IMG_W))
    return out, manifest, ExportedEngine(out, device="cpu")


def _images(n, seed=0):
    return np.random.RandomState(seed).randint(
        0, 255, (n, IMG_H, IMG_W, 3)).astype(np.uint8)


def _same(got, want, box_tol=1e-5, rel_tol=1e-5):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["answer"] == w["answer"]
        np.testing.assert_allclose(g["boxes"], w["boxes"], atol=box_tol)
        np.testing.assert_allclose(g["relevance"], w["relevance"],
                                   atol=rel_tol)


# ------------------------------------------------------------ the ops

def test_ops_on_the_cpu_are_the_plain_versions():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, t, 4, 8, generator=g) for t in (5, 7, 7))
    kv = torch.rand(2, 7, generator=g) > 0.3
    for causal, (qq, kk, vv) in ((False, (q, k, v)),
                                 (True, (k, k, v))):
        assert torch.equal(
            torch.ops.gpv.fused_attention(qq, kk, vv, kv, causal),
            A.attend_plain(qq, kk, vv, kv, causal))
    xs = [torch.randn(2, t, 4, 8, generator=g) for t in (5, 5, 5, 9, 9, 9)]
    v2 = torch.rand(2, 9, generator=g) > 0.3
    for got, want in zip(torch.ops.gpv.fused_biattention(*xs, None, v2),
                         A.biattend_plain(*xs, None, v2)):
        assert torch.equal(got, want)


def test_fake_kernels_give_the_output_shapes():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        q = torch.empty(3, 1, 8, 96, dtype=torch.bfloat16)
        k = torch.empty(3, 20, 8, 96, dtype=torch.bfloat16)
        out = torch.ops.gpv.fused_attention(q, k, k, None, False)
        assert out.shape == q.shape and out.dtype == q.dtype
        a, b = (torch.empty(3, t, 16, 48) for t in (20, 100))
        c1, c2 = torch.ops.gpv.fused_biattention(a, a, a, b, b, b, None,
                                                 None)
        assert c1.shape == b.shape and c2.shape == a.shape
        assert _cuda.traced(q)  # a fake tensor routes the wrapper to the op
    assert not _cuda.traced(torch.empty(1))


# ------------------------------------------------------------ bundles

def test_bundle_files_and_weights_stored_once(bundle):
    out, manifest, _ = bundle
    assert manifest["batch_sizes"] == list(BUCKETS)
    assert sorted(manifest["programs"]) == sorted(
        f"{k}_b{b}" for k in ("encode", "step") for b in BUCKETS)
    assert manifest["device"] == "cpu" and manifest["dtype"] == "float32"
    weights = (out / "weights.pt").stat().st_size
    programs = sum((out / f"{n}.pt2").stat().st_size
                   for n in manifest["programs"])
    assert programs < 0.3 * weights


@pytest.mark.parametrize("n", [1, 2, 3])
def test_bundle_matches_the_engine(bundle, bridge, n):
    """n = 2 pads by repetition to the bucket of 3."""
    engine, exported = bridge[2], bundle[2]
    images = _images(n, seed=n)
    _same(exported.predict(images, QUERIES[:n]),
          engine.predict(images, QUERIES[:n]))
    assert exported.last_decode_steps == engine.last_decode_steps


def test_bundle_applies_the_vocab_mask(bundle, bridge):
    engine, exported = bridge[2], bundle[2]
    images = _images(2, seed=7)
    mask = np.full((len(engine.vocab),), -10000.0, np.float32)
    mask[engine.vocab.stop_id] = 0.0
    mask[5] = 0.0
    got = exported.predict(images, QUERIES[:2], mask)
    _same(got, engine.predict(images, QUERIES[:2], mask))
    assert exported.last_decode_steps == engine.last_decode_steps


@pytest.mark.parametrize("stop", ["none", "early", "never"])
def test_bundle_decodes_as_greedy_decode(bundle, bridge, monkeypatch, stop):
    """The bundle runs the engine's greedy loop over its step program: its
    tokens and steps equal `greedy_decode`'s on the engine's model, with
    no stop id, one every row emits before the last step and one no row
    emits (a vocab mask leaves few words, so that rows repeat them)."""
    engine, exported = bridge[2], bundle[2]
    n, vocab = len(QUERIES), engine.vocab
    mask = torch.full((len(vocab),), -10000.0)
    mask[[5, 6, 7]] = 0.0
    qids, qvalid = engine.tokenizer.batch_encode(QUERIES,
                                                 engine.max_query_len)
    images = torch.from_numpy(_images(n, seed=13))
    qids, qvalid = torch.from_numpy(qids).long(), torch.from_numpy(qvalid)
    with torch.inference_mode():
        memory, mem_valid, _, _ = encode_sorted(engine.model, images, qids,
                                                qvalid)
        free, _, _ = greedy_decode(engine.model, memory, mem_valid,
                                   vocab.cls_id, mask)
        first = {i: int((free == i).int().argmax(1).max()) for i in (5, 6, 7)
                 if bool((free == i).any(1).all())}
        early = min(first, key=first.get)
        assert first[early] < free.shape[1] - 1
        stop_id = {"none": None, "early": early, "never": 8}[stop]
        want, _, steps = greedy_decode(engine.model, memory, mem_valid,
                                       vocab.cls_id, mask, stop_id)
        state = exported._programs["encode", n](
            exported._weights["encode"], images, qids, qvalid)
        monkeypatch.setattr(exported.vocab, "stop_id", stop_id)
        got = exported._greedy(n, state, mask)
    assert torch.equal(got, want)
    assert exported.last_decode_steps == steps
    assert steps < free.shape[1] if stop == "early" else \
        steps == free.shape[1]


def test_bundle_refuses_oversize_batches_and_other_sizes(bundle):
    exported = bundle[2]
    with pytest.raises(ValueError, match="largest exported bucket"):
        exported.predict(_images(4), QUERIES + ["x"])
    with pytest.raises(ValueError, match="exported for images"):
        exported.predict(np.zeros((1, IMG_H + 1, IMG_W, 3), np.uint8),
                         QUERIES[:1])
    with pytest.raises(ValueError, match="exported on cpu"):
        ExportedEngine(bundle[0], device="meta")


def test_bundle_matches_the_jax_bundle(bundle, bridge, tmp_path):
    """The same weights through the JAX package's own bundle."""
    out = tmp_path / "jax_bundle"
    jax_export_engine(bridge[0], out, batch_sizes=(2,),
                      image_hw=(IMG_H, IMG_W))
    images = _images(2, seed=11)
    _same(bundle[2].predict(images, QUERIES[:2]),
          JaxExportedEngine(out).predict(images, QUERIES[:2]),
          BOX_TOL, REL_TOL)


_LOADER = """
import json, sys
import numpy as np
from gpv_tpu_torch.export import ExportedEngine
eng = ExportedEngine(sys.argv[1], device="cpu")
images = np.random.RandomState(3).randint(0, 255, (3, %d, %d, 3)).astype(
    np.uint8)
out = eng.predict(images, %r)
leaked = [m for m in sys.modules if m.split(".")[:2] in (
    ["gpv_tpu_torch", "models"], ["gpv_tpu_torch", "nn"],
    ["gpv_tpu_torch", "weights"], ["gpv_tpu_torch", "infer"])
    or m.split(".")[0] in ("jax", "flax", "gpv_tpu")]
print(json.dumps({"leaked": leaked, "answers": [o["answer"] for o in out],
                  "boxes": [o["boxes"].tolist() for o in out]}))
""" % (IMG_H, IMG_W, QUERIES)


def test_a_fresh_process_loads_the_bundle_without_model_code(bundle,
                                                             bridge):
    env = _env()
    proc = subprocess.run([sys.executable, "-c", _LOADER, str(bundle[0])],
                          capture_output=True, text=True, timeout=120,
                          env=env, cwd=str(bundle[0]))
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["leaked"] == []
    want = bridge[2].predict(_images(3, seed=3), QUERIES)
    assert got["answers"] == [w["answer"] for w in want]
    np.testing.assert_allclose(np.asarray(got["boxes"]),
                               np.stack([w["boxes"] for w in want]),
                               atol=1e-5)


# ------------------------------------------------------------ serving

def _env() -> dict:
    """This environment with the repository first on the import path."""
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + ([path] if path else [])))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(base, payload):
    req = urllib.request.Request(
        base + "/predict", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_serve_http_serves_a_bundle(bundle, tmp_path):
    """`serve_http bundle=` from a directory without configs/: greedy
    requests answer as the bundle does, a beam request is a 400, SIGTERM
    drains and exits 0."""
    import base64
    import io

    from PIL import Image
    port = _free_port()
    env = _env()
    proc = subprocess.Popen(
        [sys.executable, "-m", "gpv_tpu_torch.cli.serve_http",
         f"bundle={bundle[0]}", f"port={port}", "host=127.0.0.1",
         "serve.warmup=false", "device=cpu"], cwd=str(tmp_path), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 90
        while True:
            assert proc.poll() is None, proc.stdout.read()[-3000:]
            try:
                with urllib.request.urlopen(base + "/healthz", timeout=5):
                    break
            except OSError:
                assert time.time() < deadline
                time.sleep(0.5)
        img = _images(1, seed=5)[0]
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "PNG")
        b64 = base64.b64encode(buf.getvalue()).decode()
        out = _post(base, {"image": b64, "query": QUERIES[0]})
        want = bundle[2].predict(img[None], QUERIES[:1])[0]
        assert out["answer"] == want["answer"]
        np.testing.assert_allclose(np.asarray(out["boxes"]), want["boxes"],
                                   atol=1e-5)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, {"image": b64, "query": "q", "beam_size": 3})
        assert ei.value.code == 400
        assert "beam" in json.loads(ei.value.read())["error"]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()


def test_export_cli_writes_a_bundle(bridge, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(ROOT)
    out = tmp_path / "cli_bundle"
    summary = export_serving.main(
        [f"ckpt={bridge[1]}", f"out={out}", "batch_sizes=[2]",
         f"image_h={IMG_H}", f"image_w={IMG_W}", "device=cpu",
         "tpu.dtype=float32"] + TINY_OVERRIDES)
    assert json.loads(capsys.readouterr().out.strip()) == summary == {
        "out": str(out), "modules": ["encode_b2", "step_b2"],
        "platforms": ["cpu"]}
    images = _images(2, seed=13)
    _same(ExportedEngine(out, device="cpu").predict(images, QUERIES[:2]),
          bridge[2].predict(images, QUERIES[:2]))
