"""The port's serving surface on the CPU: `GPVServer` (batching, beam
routing, stats, cancellation, vocab-mask isolation, close with and without
drain, buckets, deferral), the HTTP front end and its client, and the
answer-vocabulary embedding against `gpv_tpu`.

The server cases mirror tests/test_serve.py and tests/test_serve_http.py
on a tiny port engine (fp32, the kernels' plain versions); each result is
held against a direct call of the same engine.
"""
import base64
import io
import json
import queue
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import CancelledError, Future

import numpy as np
import pytest
import torch

from gpv_tpu_torch.cli.serve_http import make_http_server, serve_in_thread
from gpv_tpu_torch.client import GPVClient
from gpv_tpu_torch.engine import GPVEngine
from gpv_tpu_torch.evaluation.vocab_mask import coco_synonyms, coco_vocab_mask
from gpv_tpu_torch.models.gpv import GPV
from gpv_tpu_torch.serve import GPVServer
from gpv_tpu_torch.text.vocab import AnswerVocab
from gpv_tpu_torch.text.wordpiece import WordPieceTokenizer
from gpv_tpu_torch.weights import init_random

VOCAB, H, W = 40, 48, 64


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engine():
    model = GPV(vocab_size=VOCAB, hidden_dim=32, max_text_len=6,
                co_att_num_layers=1, co_att_heads=4, co_att_intermediate=64,
                text_decoder_layers=1, text_decoder_heads=4,
                detr_cfg=dict(num_queries=10, hidden_dim=32, nheads=4,
                              num_encoder_layers=1, num_decoder_layers=1,
                              dim_feedforward=64,
                              backbone_layers=(1, 1, 1, 1)),
                bert_layers=1, bert_hidden=32, bert_heads=4,
                bert_vocab_size=100, bert_max_len=16)
    init_random(model, seed=3)
    return GPVEngine(model, AnswerVocab.debug(size=VOCAB),
                     WordPieceTokenizer.debug(), device="cpu",
                     dtype=torch.float32)


def _images(seed, n, h=H, w=W):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 255, (h, w, 3), np.uint8) for _ in range(n)]


def _one_token_mask(tok):
    m = np.full((VOCAB,), -10000.0, np.float32)
    m[tok] = 0.0
    return m


class TestServer:
    def test_all_requests_resolve_and_match_direct(self, engine):
        images = _images(0, 9)
        queries = [f"what is {i}?" for i in range(9)]
        server = GPVServer(engine, batch_size=4, max_wait_ms=50,
                           num_workers=1)
        futs = [server.submit(im, q) for im, q in zip(images, queries)]
        results = [f.result(timeout=120) for f in futs]
        server.close()
        for im, q, got in zip(images, queries, results):
            ref = engine.predict(im[None], [q])[0]
            assert got["answer"] == ref["answer"]
            np.testing.assert_allclose(got["boxes"], ref["boxes"], atol=1e-4)

    def test_beam_requests_batch_separately_and_match_direct(self, engine):
        images = _images(3, 4)
        server = GPVServer(engine, batch_size=2, max_wait_ms=50,
                           num_workers=1)
        futs = [server.submit(im, f"what is {i}?",
                              beam_size=3 if i % 2 else None)
                for i, im in enumerate(images)]
        results = [f.result(timeout=120) for f in futs]
        server.close()
        for i, (im, got) in enumerate(zip(images, results)):
            if i % 2:
                ref = engine.predict_beam(im[None], [f"what is {i}?"],
                                          beam_size=3)[0]
                assert got["answers"] == ref["answers"]
                np.testing.assert_allclose(got["answer_probs"],
                                           ref["answer_probs"], atol=1e-4)
                assert got["answer"] == ref["answers"][0]
            else:
                ref = engine.predict(im[None], [f"what is {i}?"])[0]
                assert got["answer"] == ref["answer"]
                assert "answers" not in got

    def test_beam_size_one_still_returns_answers_key(self, engine):
        img = _images(5, 1)[0]
        server = GPVServer(engine, batch_size=1, max_wait_ms=1,
                           num_workers=1)
        try:
            out = server.submit(img, "what?", beam_size=1).result(
                timeout=120)
            assert out["answers"] == [out["answer"]]
            assert len(out["answer_probs"]) == 1
            with pytest.raises(ValueError, match="beam_size"):
                server.submit(img, "what?", beam_size=0)
        finally:
            server.close()

    def test_stats_counters_account_for_all_traffic(self, engine):
        server = GPVServer(engine, batch_size=4, max_wait_ms=50,
                           num_workers=1)
        futs = [server.submit(im, f"q {i}")
                for i, im in enumerate(_images(3, 7))]
        for f in futs:
            f.result(timeout=120)
        s = server.stats()
        server.close()
        assert (s["submitted"], s["completed"], s["failed"],
                s["queued"]) == (7, 7, 0, 0)
        executed = sum(b * n for b, n in s["batches_per_bucket"].items())
        assert executed >= 7
        assert s["batch_occupancy"] == pytest.approx(7 / executed)
        assert s["latency_ms"]["n"] == 7
        assert s["latency_ms"]["p50"] <= s["latency_ms"]["p99"]

    def test_cancelled_future_does_not_fail_or_double_count(self, engine):
        server = GPVServer(engine, batch_size=2, max_wait_ms=1,
                           num_workers=1)
        try:
            img = _images(9, 1)[0]
            f_ok, f_cancel = Future(), Future()
            f_cancel.cancel()
            t0 = time.monotonic()
            server._execute([(img, "keep me", None, None, f_ok, t0),
                             (img, "cancelled", None, None, f_cancel, t0)])
            assert isinstance(f_ok.result(timeout=60)["answer"], str)
            assert f_cancel.cancelled()
            s = server.stats()
            assert s["failed"] == 0 and s["completed"] == 1
            assert sum(s["batches_per_bucket"].values()) == 1
        finally:
            server.close()

    def test_concurrent_distinct_vocab_masks_are_isolated(self, engine):
        masks = [_one_token_mask(5), _one_token_mask(7), None]
        images = _images(1, 9)
        queries = [f"what is {i}?" for i in range(9)]
        server = GPVServer(engine, batch_size=4, max_wait_ms=50,
                           num_workers=1)
        futs = [server.submit(im, q, masks[i % 3])
                for i, (im, q) in enumerate(zip(images, queries))]
        results = [f.result(timeout=120) for f in futs]
        server.close()
        for i, (im, q, got) in enumerate(zip(images, queries, results)):
            ref = engine.predict(im[None], [q], masks[i % 3])[0]
            assert got["answer"] == ref["answer"], i
        assert results[0]["answer"] != results[1]["answer"]

    def test_closed_server_rejects(self, engine):
        server = GPVServer(engine, batch_size=2, num_workers=1)
        server.close()
        with pytest.raises(RuntimeError, match="closed"):
            server.submit(np.zeros((H, W, 3), np.uint8), "q")

    def test_masked_beam_requests_match_direct(self, engine):
        """Beam requests under two vocab masks batch apart and each gets
        the engine's masked beam search."""
        masks = [_one_token_mask(5), None]
        images = _images(13, 4)
        server = GPVServer(engine, batch_size=4, max_wait_ms=50,
                           num_workers=1)
        futs = [server.submit(im, f"mask {i}", masks[i % 2], beam_size=2)
                for i, im in enumerate(images)]
        results = [f.result(timeout=120) for f in futs]
        server.close()
        for i, (im, got) in enumerate(zip(images, results)):
            ref = engine.predict_beam(im[None], [f"mask {i}"], beam_size=2,
                                      vocab_mask=masks[i % 2])[0]
            assert got["answers"] == ref["answers"], i
            np.testing.assert_allclose(got["answer_probs"],
                                       ref["answer_probs"], atol=1e-4)
        assert set(results[0]["answers"][0].split()) == \
            {engine.vocab.words[5]}

    def test_close_drains_queued_requests(self, engine):
        server = GPVServer(engine, batch_size=2, max_wait_ms=5,
                           num_workers=1)
        futs = [server.submit(im, f"drain {i}")
                for i, im in enumerate(_images(11, 5))]
        server.close()
        for f in futs:
            assert f.done() and not f.cancelled()
            assert isinstance(f.result(timeout=1)["answer"], str)

    def test_close_without_drain_cancels_unserved(self, engine):
        gate, entered = threading.Event(), threading.Event()

        class _BlockingEngine:
            vocab = engine.vocab

            def predict(self, images, queries, mask=None):
                entered.set()
                assert gate.wait(timeout=120)
                return engine.predict(images, queries, mask)

        server = GPVServer(_BlockingEngine(), batch_size=2, max_wait_ms=1,
                           num_workers=1)
        futs = [server.submit(im, f"cancel {i}")
                for i, im in enumerate(_images(12, 6))]
        assert entered.wait(timeout=60)
        closer = threading.Thread(
            target=lambda: server.close(drain=False, timeout=4))
        closer.start()
        closer.join(timeout=60)
        assert not closer.is_alive()
        gate.set()
        resolved = cancelled = 0
        for f in futs:
            try:
                f.result(timeout=60)
                resolved += 1
            except CancelledError:
                cancelled += 1
        assert (resolved, cancelled) == (2, 4)

    def test_warmup_runs_each_bucket_with_and_without_a_mask(self):
        calls = []

        class _SpyEngine:
            vocab = AnswerVocab.debug(size=VOCAB)

            def predict(self, images, queries, mask=None):
                calls.append((len(queries), images.shape[1:3],
                              mask is not None))
                return [{"answer": "", "boxes": None, "relevance": None}
                        for _ in queries]

        server = GPVServer(_SpyEngine(), bucket_sizes=(1, 3),
                           num_workers=1, warmup=(H, W))
        server.close()
        assert calls == [(1, (H, W), False), (1, (H, W), True),
                         (3, (H, W), False), (3, (H, W), True)]


def test_decode_steps_are_counted_per_thread(engine):
    """The server's workers share one engine: each thread reads the step
    count of its own last call (greedy stopped at once by a mask that
    allows only `__stop__`, beam always max_text_len - 1)."""
    img = _images(14, 1)[0][None]
    stop = _one_token_mask(engine.vocab.stop_id)
    steps, ready = {}, threading.Barrier(2)

    def run(name, call):
        call()
        ready.wait(timeout=60)   # both calls done before either reads
        steps[name] = engine.last_decode_steps

    threads = [threading.Thread(target=run, args=(
        "greedy", lambda: engine.predict(img, ["q"], stop))),
        threading.Thread(target=run, args=(
            "beam", lambda: engine.predict_beam(img, ["q"], beam_size=2)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert steps == {"greedy": 1, "beam": 5}


class TestCollectScheduling:
    """The batch-collection policy, driven directly (no engine)."""

    @staticmethod
    def _server(batch_size):
        srv = GPVServer.__new__(GPVServer)
        srv.batch_size = batch_size
        srv.max_wait_s = 0.01
        srv._q = queue.Queue()
        srv._pending = []
        srv._pending_lock = threading.Lock()
        srv._stats_lock = threading.Lock()
        srv._lifecycle_lock = threading.Lock()
        srv._busy = 0
        srv._closed = threading.Event()
        srv._deferred = 0
        return srv

    @staticmethod
    def _req(tag, mask, beam=None):
        return (tag, f"query-{tag}", mask, beam, Future(), time.monotonic())

    def test_deferred_minority_mask_served_next_batch(self):
        ma, mb = np.zeros((4,), np.float32), np.ones((4,), np.float32)
        srv = self._server(batch_size=2)
        for it in (self._req("a1", ma), self._req("b1", mb),
                   self._req("a2", ma), self._req("a3", ma)):
            srv._q.put(it)
        assert [it[0] for it in srv._collect()] == ["a1", "a2"]
        assert [it[0] for it in srv._pending] == ["b1"]
        assert [it[0] for it in srv._collect()] == ["b1"]
        assert [it[0] for it in srv._collect()] == ["a3"]

    def test_same_mask_pending_items_batch_together(self):
        ma, mb = np.zeros((4,), np.float32), np.ones((4,), np.float32)
        srv = self._server(batch_size=3)
        srv._pending = [self._req("b1", mb), self._req("a1", ma),
                        self._req("b2", mb)]
        srv._q.put(self._req("b3", mb))
        assert [it[0] for it in srv._collect()] == ["b1", "b2", "b3"]
        assert [it[0] for it in srv._pending] == ["a1"]

    def test_beam_size_is_part_of_the_batch_key(self):
        srv = self._server(batch_size=3)
        for it in (self._req("g1", None), self._req("k3", None, 3),
                   self._req("g2", None)):
            srv._q.put(it)
        assert [it[0] for it in srv._collect()] == ["g1", "g2"]
        assert [it[0] for it in srv._collect()] == ["k3"]


class TestBucketedPadding:
    class _SpyEngine:
        def __init__(self):
            self.batch_sizes = []

        def predict(self, images, queries, mask=None):
            self.batch_sizes.append(len(queries))
            return [{"answer": q, "boxes": None, "relevance": None}
                    for q in queries]

    @pytest.mark.parametrize("n,buckets,want", [
        (1, (1, 4, 16), [1]),     # a lone request takes the smallest
        (3, (1, 4, 16), [4]),     # 3 requests round up to 4, not 16
        (1, None, [8]),           # no buckets: always batch_size
    ])
    def test_batches_pad_to_the_smallest_bucket(self, n, buckets, want):
        spy = self._SpyEngine()
        srv = GPVServer(spy, batch_size=8, max_wait_ms=200, num_workers=1,
                        bucket_sizes=buckets)
        img = np.zeros((8, 8, 3), np.uint8)
        futs = [srv.submit(img, f"q{i}") for i in range(n)]
        outs = [f.result(timeout=30)["answer"] for f in futs]
        srv.close()
        assert outs == [f"q{i}" for i in range(n)]
        assert spy.batch_sizes == want


# ------------------------------------------------------------------ HTTP

def _b64_png(img):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _post(base, payload, timeout=120):
    req = urllib.request.Request(
        base + "/predict", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def http_stack(engine):
    mask = _one_token_mask(5)
    srv = GPVServer(engine, bucket_sizes=(1, 2), max_wait_ms=10,
                    num_workers=1)
    httpd = make_http_server(srv, {"vqa": None, "classification": mask},
                             (H, W), host="127.0.0.1", port=0)
    serve_in_thread(httpd)
    yield f"http://127.0.0.1:{httpd.server_address[1]}", mask
    httpd.shutdown()
    srv.close()
    httpd.server_close()


class TestHttp:
    def test_healthz(self, http_stack):
        with urllib.request.urlopen(http_stack[0] + "/healthz",
                                    timeout=30) as r:
            assert json.loads(r.read())["ok"] is True

    def test_predict_matches_direct_engine(self, http_stack, engine):
        base, mask = http_stack
        img = _images(0, 1)[0]
        out = _post(base, {"image": _b64_png(img), "query": "what is this?",
                           "task": "classification"})
        assert len(out["boxes"]) == 10 and len(out["boxes"][0]) == 4
        assert len(out["relevance"]) == 10
        ref = engine.predict(img[None], ["what is this?"], mask)[0]
        assert out["answer"] == ref["answer"]
        np.testing.assert_allclose(np.asarray(out["boxes"]), ref["boxes"],
                                   atol=1e-5)

    def test_beam_request_returns_k_answers(self, http_stack, engine):
        base, _ = http_stack
        img = _images(7, 1)[0]
        out = _post(base, {"image": _b64_png(img),
                           "query": "describe the image", "beam_size": 3})
        assert len(out["answers"]) == 3
        assert out["answer"] == out["answers"][0]
        assert np.all(np.diff(out["answer_probs"]) <= 1e-6)
        ref = engine.predict_beam(img[None], ["describe the image"],
                                  beam_size=3)[0]
        assert out["answers"] == ref["answers"]

    @pytest.mark.parametrize("payload,code", [
        ({"query": "q", "beam_size": 21}, 400),   # beam out of range
        ({"query": "q", "beam_size": 0}, 400),
        ({"query": "q", "task": "nope"}, 400),    # unknown task
        ({"query": "no image"}, 400),             # malformed
    ], ids=["beam_21", "beam_0", "unknown_task", "malformed"])
    def test_bad_requests_are_400(self, http_stack, payload, code):
        base, _ = http_stack
        if "query" in payload and payload["query"] != "no image":
            payload = dict(payload,
                           image=_b64_png(np.zeros((8, 8, 3), np.uint8)))
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, payload, timeout=30)
        assert ei.value.code == code

    def test_unknown_path_is_404(self, http_stack):
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(http_stack[0] + "/nope", timeout=30)
        assert ei.value.code == 404

    def test_resizes_native_input(self, http_stack):
        img = _images(1, 1, 100, 130)[0]
        out = _post(http_stack[0], {"image": _b64_png(img),
                                    "query": "a photo of"})
        assert isinstance(out["answer"], str)

    def test_client_round_trip(self, http_stack, engine, tmp_path):
        base, mask = http_stack
        client = GPVClient(base)
        assert client.healthy()
        img = _images(21, 1)[0]
        ref = engine.predict(img[None], ["client test"])[0]
        out = client.predict(img, "client test")
        assert out["answer"] == ref["answer"]
        np.testing.assert_allclose(out["boxes"], ref["boxes"], atol=1e-5)
        path = tmp_path / "img.png"
        path.write_bytes(base64.b64decode(_b64_png(img)))
        assert client.predict(path.read_bytes(),
                              "client test")["answer"] == ref["answer"]
        assert client.predict(str(path), "client test")["answer"] == \
            ref["answer"]
        masked = client.predict(img, "client test", task="classification")
        assert masked["answer"] == engine.predict(
            img[None], ["client test"], mask)[0]["answer"]
        beam = client.predict(img, "client test", beam_size=2)
        assert len(beam["answers"]) == 2
        with pytest.raises(RuntimeError, match="unknown task"):
            client.predict(img, "q", task="nope")
        assert client.stats()["completed"] >= 4

    def test_stats_endpoint(self, http_stack):
        base, _ = http_stack
        _post(base, {"image": _b64_png(_images(7, 1)[0]),
                     "query": "stats probe"})
        s = GPVClient(base).stats()
        assert s["submitted"] >= s["completed"] >= 1
        assert s["failed"] == 0
        assert s["latency_ms"]["p50"] <= s["latency_ms"]["p99"]
        assert 0 < s["batch_occupancy"] <= 1


def test_bundle_mode_is_refused():
    """`bundle=` serves an exported bundle (tests/test_torch_port_export.py);
    a directory that holds none is refused before anything listens."""
    from gpv_tpu_torch.cli.serve_http import main
    with pytest.raises(FileNotFoundError, match="manifest.json"):
        main(["bundle=/nonexistent", "device=cpu"])


# ------------------------------------------------- vocab masks, embedding

@pytest.mark.parametrize("use_syns", [False, True])
def test_coco_vocab_mask_matches_jax(use_syns):
    from gpv_tpu.evaluation.evaluators import coco_vocab_mask as jax_mask
    from gpv_tpu.text.vocab import AnswerVocab as JaxVocab
    words = ["dog", "cat", "person", "hot", "dog", "tv", "couch", "sofa",
             "motorbike"]
    got = coco_vocab_mask(AnswerVocab.debug(extra_words=words), use_syns)
    want = jax_mask(JaxVocab.debug(extra_words=words), use_syns)
    np.testing.assert_array_equal(got, want)
    assert len(coco_synonyms()) == 80


def test_embed_vocab_matches_jax():
    import jax
    import jax.numpy as jnp
    from gpv_tpu.data.vocab_embed import embed_vocab as jax_embed
    from gpv_tpu.nn.bert import BertEncoder as JaxBert
    from gpv_tpu_torch.data.vocab_embed import embed_vocab
    from gpv_tpu_torch.nn.bert import BertEncoder
    from gpv_tpu_torch.weights import bert as bert_sd

    kw = dict(num_layers=2, hidden=32, heads=4, intermediate=64,
              vocab_size=100, max_len=16)
    tok = WordPieceTokenizer.debug()
    words = AnswerVocab.debug(size=70).words
    ids, valid = tok.batch_encode(words[:1], 16)
    params = JaxBert(**kw).init(jax.random.PRNGKey(1), jnp.asarray(ids),
                                valid=jnp.asarray(valid))["params"]
    params = jax.tree.map(np.asarray, params)
    want = jax_embed(words, tok, params, batch_size=32, bert_kwargs=kw)
    bert = BertEncoder(2, 32, 4, 64, 100, 16)
    bert.load_state_dict(bert_sd(params), strict=True)
    got = embed_vocab(words, tok, bert, batch_size=32, device="cpu")
    assert got.shape == (70, 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_compute_vocab_embed_cli_writes_the_array(tmp_path, capsys):
    from gpv_tpu_torch.cli.compute_vocab_embed import main
    words = ["dog", "hot dog", "red", "two"]
    (tmp_path / "vocab.json").write_text(json.dumps(words))
    main([f"vocab={tmp_path / 'vocab.json'}", f"out={tmp_path / 'e.npy'}",
          "device=cpu"])
    emb = np.load(tmp_path / "e.npy")
    assert emb.shape == (4, 768) and np.isfinite(emb).all()
    assert "shape=(4, 768)" in capsys.readouterr().out
