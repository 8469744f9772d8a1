"""The port's spans (`gpv_tpu_torch.utils.profiling`) on the CPU: off by
default and then recording nothing; on, the documented spans of a greedy
`predict`, a train step (grad_accum 1 and 2) and `GPVServer`, in their
nesting and counts, with outputs bit-equal to a run with spans off; a
recording torch.profiler turns them on and sees them as ranges; the
buffer stays bounded and `drain` empties it."""
import threading
import time

import numpy as np
import pytest
import torch

from _torch_train_common import make_batch, port_model, training_cfg
from gpv_tpu_torch.engine import GPVEngine
from gpv_tpu_torch.losses.criterion import LossConfig
from gpv_tpu_torch.models.gpv import GPV
from gpv_tpu_torch.parallel.train_step import TrainState, make_train_step
from gpv_tpu_torch.serve import GPVServer
from gpv_tpu_torch.text.vocab import AnswerVocab
from gpv_tpu_torch.text.wordpiece import WordPieceTokenizer
from gpv_tpu_torch.train.optimizer import build_optimizer
from gpv_tpu_torch.utils import profiling
from gpv_tpu_torch.utils.profiling import record, span
from gpv_tpu_torch.weights import init_random

VOCAB, H, W = 40, 48, 64
PREDICT = ("engine.tokenize", "engine.upload", "engine.encode",
           "decode.step", "engine.fetch", "engine.detokenize")


@pytest.fixture(autouse=True)
def spans_off():
    profiling.disable()
    profiling.drain()
    yield
    profiling.disable()
    profiling.drain()


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


def _inputs(n, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 255, (n, H, W, 3), np.uint8),
            [f"what is {i}?" for i in range(n)])


def _names(recs):
    out = {}
    for r in recs:
        out[r.name] = out.get(r.name, 0) + 1
    return out


def _inside(inner, outer):
    return (outer.thread == inner.thread and outer.start_ns <= inner.start_ns
            and inner.end_ns <= outer.end_ns)


# ---- the span machinery

def test_off_records_nothing_through_one_shared_context():
    assert span("a") is span("b")
    with span("a"):
        with span("b"):
            pass
    record("c", 1, 2)
    assert profiling.drain() == []


def test_on_records_name_thread_clock_and_cpu_where_asked():
    profiling.enable()
    t0 = time.perf_counter_ns()
    with span("outer"):
        with span("inner"):
            sum(range(10000))
    t1 = time.perf_counter_ns()
    record("handed", t0, t1)

    def worker():
        profiling.thread_cpu()
        with span("timed"):
            sum(range(10000))
    th = threading.Thread(target=worker)
    th.start()
    th.join(timeout=60)
    assert not th.is_alive()
    recs = profiling.drain()
    assert [r.name for r in recs] == ["inner", "outer", "handed", "timed"]
    inner, outer, handed, timed = recs
    assert _inside(inner, outer)
    assert t0 <= outer.start_ns <= outer.end_ns <= t1
    for r in (inner, outer, handed):
        assert r.thread == threading.get_ident()
        assert r.cpu_start_ns is None and r.cpu_end_ns is None
    assert (handed.start_ns, handed.end_ns) == (t0, t1)
    assert timed.thread == th.ident != threading.get_ident()
    assert 0 < timed.cpu_end_ns - timed.cpu_start_ns
    assert profiling.drain() == []
    profiling.disable()
    with span("later"):
        pass
    assert profiling.drain() == []


def test_the_buffer_stays_bounded_and_drain_clears_it():
    profiling.enable()
    n = profiling.MAX_RECORDS + 100
    for i in range(n):
        record("r", i, i + 1)
    recs = profiling.drain()
    assert len(recs) == profiling.MAX_RECORDS
    assert recs[0].start_ns == 100 and recs[-1].start_ns == n - 1
    assert profiling.drain() == []


def test_a_recording_profiler_turns_spans_on_and_sees_them():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("engine.upload"):
            torch.ones(4).add_(1)
    assert [r.name for r in profiling.drain()] == ["engine.upload"]
    assert "engine.upload" in {e.name for e in prof.events()}
    with span("engine.upload"):
        pass
    assert profiling.drain() == []


# ---- the program's spans

def _same_outputs(a, b):
    assert [o["answer"] for o in a] == [o["answer"] for o in b]
    for x, y in zip(a, b):
        assert np.array_equal(x["boxes"], y["boxes"])
        assert np.array_equal(x["relevance"], y["relevance"])


def test_predict_spans_nest_and_leave_outputs_bit_equal(engine):
    images, queries = _inputs(3)
    off = engine.predict(images, queries)
    assert profiling.drain() == []
    profiling.enable()
    on = engine.predict(images, queries)
    recs = profiling.drain()
    _same_outputs(off, on)
    steps = engine.last_decode_steps
    counts = _names(recs)
    assert counts == {"engine.tokenize": 1, "engine.upload": 1,
                      "engine.encode": 1, "encode.detr": 1, "encode.bert": 1,
                      "encode.coattention": 1, "decode.prepare": 1,
                      "engine.fetch": 1, "engine.detokenize": 1,
                      "decode.step": steps, "decode.stop_wait": steps}
    # the stages follow one another; the model's encode stages nest in
    # `engine.encode`, each stop_wait in its step
    (encode,) = [r for r in recs if r.name == "engine.encode"]
    stages = sorted((r for r in recs if r.name.startswith("encode.")),
                    key=lambda r: r.start_ns)
    assert [r.name for r in stages] == ["encode.detr", "encode.bert",
                                        "encode.coattention"]
    assert all(_inside(r, encode) for r in stages)
    top = sorted((r for r in recs if r.name != "decode.stop_wait"
                  and not r.name.startswith("encode.")),
                 key=lambda r: r.start_ns)
    assert [r.name for r in top] == (list(PREDICT[:3])
                                     + ["decode.prepare"]
                                     + ["decode.step"] * steps
                                     + list(PREDICT[4:]))
    for a, b in zip(top, top[1:]):
        assert a.end_ns <= b.start_ns
    step_recs = [r for r in top if r.name == "decode.step"]
    waits = sorted((r for r in recs if r.name == "decode.stop_wait"),
                   key=lambda r: r.start_ns)
    for w, s in zip(waits, step_recs):
        assert _inside(w, s)


def _dedup(batch):
    """The collator's dedup fields: each distinct (ids, valid) query row
    once, and each row's index into them."""
    keys = np.concatenate([batch["query_ids"],
                           batch["query_valid"].astype(np.int32)], 1)
    _, first, gather = np.unique(keys, axis=0, return_index=True,
                                 return_inverse=True)
    return dict(batch, query_uniq_ids=batch["query_ids"][first],
                query_uniq_valid=batch["query_valid"][first],
                query_gather=gather.reshape(-1).astype(np.int64))


def _train(grad_accum, batch):
    torch.manual_seed(0)
    pm = port_model()
    init_random(pm, seed=4)
    opt, sched = build_optimizer(training_cfg(), 10, pm)
    step = make_train_step(pm, LossConfig(), 0.1, grad_accum=grad_accum)
    losses = step(TrainState(pm, opt, sched), batch)
    return ({k: v.clone() for k, v in losses.items()},
            {n: p.detach().clone() for n, p in pm.named_parameters()})


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_spans_count_and_leave_the_step_bit_equal(grad_accum):
    batch = _dedup(make_batch(8, repeat_queries=True))
    assert len(batch["query_uniq_ids"]) < 8
    losses_off, params_off = _train(grad_accum, batch)
    assert profiling.drain() == []
    profiling.enable()
    losses_on, params_on = _train(grad_accum, batch)
    recs = profiling.drain()
    assert losses_off.keys() == losses_on.keys()
    for k in losses_off:
        assert torch.equal(losses_off[k], losses_on[k]), k
    for n in params_off:
        assert torch.equal(params_off[n], params_on[n]), n
    assert _names(recs) == {
        "train.upload": 1, "train.query_encode": 1,
        "train.forward": grad_accum, "encode.detr": grad_accum,
        "encode.bert": grad_accum, "encode.coattention": grad_accum,
        "train.matcher.wait": grad_accum, "train.matcher.solve": grad_accum,
        "train.backward": grad_accum, "train.clip": 1, "train.adamw": 1}
    forwards = [r for r in recs if r.name == "train.forward"]
    for r in recs:
        if r.name.startswith(("train.matcher.", "encode.")):
            assert any(_inside(r, f) for f in forwards), r


def test_server_records_each_request_from_its_submit(engine):
    images, queries = _inputs(7, seed=1)
    server = GPVServer(engine, batch_size=4, max_wait_ms=20,
                       num_workers=2)
    try:
        profiling.enable()
        submitted = []
        for im, q in zip(images, queries):
            t0 = time.perf_counter_ns()
            fut = server.submit(im, q)
            submitted.append((t0, time.perf_counter_ns(), fut))
        outs = [f.result(timeout=120) for _, _, f in submitted]
        workers = {w.ident for w in server._workers}
    finally:
        server.close()
    profiling.disable()
    recs = profiling.drain()
    assert len(outs) == 7
    queue_recs = sorted((r for r in recs if r.name == "serve.queue"),
                        key=lambda r: r.start_ns)
    assert len(queue_recs) == 7
    for (a, b, _), r in zip(submitted, queue_recs):
        assert a <= r.start_ns <= b <= r.end_ns
    served = [r for r in recs if r.name.startswith("serve.")]
    assert {r.thread for r in served} <= workers
    for r in recs:   # the workers' spans carry their CPU time
        assert (r.cpu_start_ns is None) == (r.name == "serve.queue"), r
    assert threading.get_ident() not in {r.thread for r in recs}
    counts = _names(recs)
    batches = counts["serve.execute"]
    assert counts["serve.coalesce"] == counts["serve.resolve"] == batches
    assert counts["engine.encode"] == batches
    executes = [r for r in recs if r.name == "serve.execute"]
    for r in recs:
        if r.name.startswith(("engine.", "encode.", "decode.")):
            assert any(_inside(r, e) for e in executes), r
