"""Data-parallel inference in the port (`GPVEngine(devices=...)`,
`tpu.infer_data_parallel`): the cases of tests/test_engine_sharded.py,
for the port's engine over `cpu, cpu` against the JAX engine over 2 of
conftest's virtual CPU devices and against the port's one-device engine.

Tolerances are those of tests/test_engine_sharded.py (answers equal,
boxes and relevance 1e-5) against the one-device engine of the same
package, and the slice's parity tolerances (answers equal, boxes 2e-4,
relevance 5e-4) against the JAX engine.
"""
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh

from gpv_tpu.engine import GPVEngine as JaxEngine
from gpv_tpu.models.gpv import GPV as JaxGPV
from gpv_tpu.text.vocab import AnswerVocab as JaxVocab
from gpv_tpu.text.wordpiece import WordPieceTokenizer as JaxTok

from gpv_tpu_torch.engine import GPVEngine
from gpv_tpu_torch.export import export_engine
from gpv_tpu_torch.infer.build import build_engine, infer_devices
from gpv_tpu_torch.models.gpv import GPV
from gpv_tpu_torch.serve import GPVServer
from gpv_tpu_torch.text.vocab import AnswerVocab
from gpv_tpu_torch.text.wordpiece import WordPieceTokenizer
from gpv_tpu_torch.utils import config as port_config
from gpv_tpu_torch.weights import state_dict_from_jax

from _fake_data import TINY_OVERRIDES

VOCAB, D, H, W = 40, 32, 48, 64
DETR_CFG = dict(num_queries=10, num_classes=1, hidden_dim=D, nheads=4,
                num_encoder_layers=1, num_decoder_layers=1,
                dim_feedforward=64, backbone_layers=(1, 1, 1, 1))
ARGS = dict(vocab_size=VOCAB, hidden_dim=D, max_text_len=8,
            co_att_num_layers=1, co_att_heads=4, co_att_intermediate=64,
            text_decoder_layers=1, text_decoder_heads=4, bert_layers=1,
            bert_hidden=D, bert_heads=4, bert_vocab_size=100,
            bert_max_len=16)
TWO_CPUS = ["cpu", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines():
    """(JAX engine over 2 virtual devices, port one-device, port over
    cpu, cpu), all fp32 on the same weights."""
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
    jax_eng = JaxEngine(jm, None, JaxVocab.debug(size=VOCAB), JaxTok.debug(),
                        max_query_len=8,
                        mesh=Mesh(np.asarray(jax.devices()[:2]), ("dp",)))
    jax_eng.variables = v
    pm = GPV(detr_cfg=DETR_CFG, **ARGS)
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    vocab, tok = AnswerVocab.debug(size=VOCAB), WordPieceTokenizer.debug()
    kw = dict(max_query_len=8, dtype=torch.float32)
    single = GPVEngine(pm, vocab, tok, device="cpu", **kw)
    sharded = GPVEngine(pm, vocab, tok, devices=TWO_CPUS, **kw)
    return jax_eng, single, sharded


def _imgs(n, seed=0):
    return np.random.RandomState(seed).randint(0, 255, (n, H, W, 3),
                                               np.uint8)


def _same(got, ref, atol=1e-5, rel_atol=None):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g["answer"] == r["answer"]
        np.testing.assert_allclose(g["boxes"], r["boxes"], atol=atol, rtol=0)
        np.testing.assert_allclose(g["relevance"], r["relevance"],
                                   atol=rel_atol or atol, rtol=0)


class TestShardedPredict:
    def test_weights_replicated_and_batch_sharded(self, engines):
        """One replica per distinct device (a repeated device shares it);
        8 rows over 2 devices: 4 rows a shard, each on a thread of its
        own."""
        _, _, sharded = engines
        assert sharded.devices == [torch.device("cpu")] * 2
        assert sharded.replicas[0] is sharded.replicas[1]
        seen = []

        def run(k, rows, more):
            seen.append((k, rows.tolist(), threading.current_thread().name))
            return rows * 10, more, 3 + k
        (a, b), steps = sharded._shards(run, [np.arange(8), np.arange(8)],
                                        8)
        assert sorted(s[:2] for s in seen) == [(0, [0, 1, 2, 3]),
                                               (1, [4, 5, 6, 7])]
        assert all(s[2].startswith("gpv-shard") for s in seen)
        assert a.tolist() == list(range(0, 80, 10)) and steps == [3, 4]

    def test_divisible_batch_matches_single_device_and_jax(self, engines):
        jax_eng, single, sharded = engines
        imgs = _imgs(8, seed=1)
        queries = [f"what is {i}" for i in range(8)]
        got = sharded.predict(imgs, queries)
        _same(got, single.predict(imgs, queries))
        _same(got, jax_eng.predict(imgs, queries), 2e-4, 5e-4)
        assert len(sharded.last_shard_steps) == 2

    def test_ragged_batch_pads_by_repetition(self, engines):
        """n=5 on 2 devices: padded to 6 (the last row again), 3 rows a
        shard, outputs sliced to 5."""
        jax_eng, single, sharded = engines
        imgs = _imgs(5, seed=2)
        queries = [f"query {i}" for i in range(5)]
        got = sharded.predict(imgs, queries)
        assert len(got) == 5
        _same(got, single.predict(imgs, queries))
        _same(got, jax_eng.predict(imgs, queries), 2e-4, 5e-4)

    def test_vocab_mask_replicates(self, engines):
        jax_eng, single, sharded = engines
        mask = np.full((VOCAB,), -10000.0, np.float32)
        mask[5] = mask[7] = 0.0
        imgs = _imgs(8, seed=3)
        queries = [f"pick {i}" for i in range(8)]
        got = sharded.predict(imgs, queries, vocab_mask=mask)
        _same(got, single.predict(imgs, queries, vocab_mask=mask))
        _same(got, jax_eng.predict(imgs, queries, vocab_mask=mask), 2e-4,
              5e-4)

    def test_beam_matches_single_device(self, engines):
        _, single, sharded = engines
        imgs = _imgs(3, seed=4)
        queries = [f"describe {i}" for i in range(3)]
        ref = single.predict_beam(imgs, queries, beam_size=3)
        got = sharded.predict_beam(imgs, queries, beam_size=3)
        assert len(got) == 3
        for r, g in zip(ref, got):
            assert g["answers"] == r["answers"]
            np.testing.assert_allclose(g["answer_probs"], r["answer_probs"],
                                       atol=1e-5)
            np.testing.assert_allclose(g["boxes"], r["boxes"], atol=1e-5)

    def test_native_resolution_buckets_pad_per_group(self, engines):
        _, single, sharded = engines
        rng = np.random.RandomState(5)
        images = [rng.randint(0, 255, (40, 56, 3), np.uint8)
                  for _ in range(3)]
        images += [rng.randint(0, 255, (64, 48, 3), np.uint8)
                   for _ in range(2)]
        queries = [f"native {i}" for i in range(5)]
        _same(sharded.predict_native(images, queries, bucket=32),
              single.predict_native(images, queries, bucket=32))


class TestServerComposition:
    def test_batching_server_over_sharded_engine(self, engines):
        """GPVServer coalesces onto the multi-device engine unchanged:
        bucket sizes that do not divide the devices pad inside the engine
        and answers match the one-device engine."""
        _, single, sharded = engines
        server = GPVServer(sharded, bucket_sizes=(1, 3), max_wait_ms=20,
                           num_workers=2)
        try:
            imgs = _imgs(4, seed=31)
            futs = [server.submit(imgs[i], f"compose {i}") for i in range(4)]
            ref = single.predict(imgs, [f"compose {i}" for i in range(4)])
            for f, r in zip(futs, ref):
                assert f.result(timeout=120)["answer"] == r["answer"]
        finally:
            server.close()


def _cfg(*extra):
    return port_config.load_config(
        "configs", "exp/gpv_inference",
        ["ckpt=null"] + TINY_OVERRIDES + list(extra) + ["device=cpu"])


class TestBuild:
    def test_infer_data_parallel_minus_one_on_one_device_is_the_plain_engine(
            self):
        """F3: -1 means all local devices; on the CPU (or a host with one
        card) that is one device, so build_engine builds the plain engine
        and answers exactly as with 1 (the port refused every value but 1
        before)."""
        imgs = _imgs(3, seed=7)
        queries = ["what is this?", "dog", "a cat"]
        plain = build_engine(_cfg("tpu.infer_data_parallel=1"))
        auto = build_engine(_cfg("tpu.infer_data_parallel=-1"))
        assert auto.devices == plain.devices == [torch.device("cpu")]
        for g, r in zip(auto.predict(imgs, queries),
                        plain.predict(imgs, queries)):
            assert g["answer"] == r["answer"]
            np.testing.assert_array_equal(g["boxes"], r["boxes"])
            np.testing.assert_array_equal(g["relevance"], r["relevance"])

    def test_build_engine_too_many_devices_raises(self):
        with pytest.raises(ValueError, match="local devices"):
            build_engine(_cfg("tpu.infer_data_parallel=2"))

    def test_infer_devices_counts_real_cards_only(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
        cards = [torch.device("cuda", i) for i in range(4)]
        assert infer_devices(-1, "cuda") == cards
        assert infer_devices(2, "cuda:0") == cards[:2]
        assert infer_devices(1, "cuda:1") == [torch.device("cuda", 1)]
        assert infer_devices(0, "cuda") == [torch.device("cuda")]
        with pytest.raises(ValueError, match="only 4 local devices"):
            infer_devices(5, "cuda")

    def test_export_rejects_multi_device_engine(self, engines, tmp_path):
        with pytest.raises(ValueError, match="single-device"):
            export_engine(engines[2], tmp_path, batch_sizes=(2,),
                          image_hw=(H, W))
