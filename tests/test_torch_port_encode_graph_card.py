"""The model encode's CUDA graphs (`gpv_tpu_torch.models.encode_graph`,
`GPV.encode`) on the card, at the released GPV's widths with a
10000-word answer vocabulary, in bf16, on 480x640 images, for the DETR
R50 detector, its DC5 variant and Deformable DETR:

- a graphed encode against the eager one at B = 1, 8 and 20: memory,
  its validity, boxes and relevance identical, and `GPVEngine.predict`'s
  answers, boxes and relevance identical;
- a key's first call runs eager, its second captures, its third replays;
- a forward hook on a deformable layer fires on a call made after a
  capture (the call runs eager);
- two threads predicting at once, each on its own streams, give what one
  thread gives;
- the counted K1, K2 and deformable sampling launches of a replayed call
  equal those kernels in a torch.profiler trace of it;
- `.to()` after a capture: the graphs are dropped, and the outputs are
  right again;
- `memory_reserved()` constant from a predict's third call on.

Card only: every test is marked `cuda` and skips without a CUDA device.
The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda \\
        tests/test_torch_port_encode_graph_card.py
"""
import contextlib
import threading
import time

import numpy as np
import pytest
import torch

from gpv_tpu_torch.engine import GPVEngine, encode_sorted
from gpv_tpu_torch.models import encode_graph
from gpv_tpu_torch.models.gpv import GPV
from gpv_tpu_torch.ops import attention as A
from gpv_tpu_torch.ops.ms_deform_attn import ms_deform_attn
from gpv_tpu_torch.text.vocab import AnswerVocab
from gpv_tpu_torch.text.wordpiece import WordPieceTokenizer
from gpv_tpu_torch.weights import init_random

VOCAB, IMG = 10000, (480, 640)
DETECTORS = {"r50": {}, "dc5": {"detr_cfg": {"dilation": True}},
             "deform": {"detector": "deformable_detr"}}
WORDS = ("man", "cat", "horse", "person", "bus")
pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def engines():
    """{name: GPVEngine}, each built at its first use."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    built = {}

    def get(name):
        if name not in built:
            model = GPV(vocab_size=VOCAB, **DETECTORS[name])
            init_random(model, seed=7)
            built[name] = GPVEngine(model, AnswerVocab.debug(size=VOCAB),
                                    WordPieceTokenizer.debug(),
                                    max_query_len=20, device="cuda",
                                    dtype=torch.bfloat16)
        return built[name]
    return get


@contextlib.contextmanager
def eager():
    """Every encode in the block runs eager, as a call that cannot be
    graphed does."""
    saved = encode_graph.graphable
    encode_graph.graphable = lambda *a: False
    try:
        yield
    finally:
        encode_graph.graphable = saved


def _batch(B, seed):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 255, (B, *IMG, 3)).astype(np.uint8)
    queries = [f"what is the {WORDS[i % 5]} doing next to the "
               f"{WORDS[(i + seed) % 5]} ?" for i in range(B)]
    return images, queries


def _device_inputs(engine, B, seed):
    images, queries = _batch(B, seed)
    qids, qvalid = engine.tokenizer.batch_encode(queries,
                                                 engine.max_query_len)
    return (torch.from_numpy(images).cuda(), torch.from_numpy(qids).cuda(),
            torch.from_numpy(qvalid).cuda())


@torch.inference_mode()
def _encode(model, inputs):
    out = encode_sorted(model, *inputs)
    torch.cuda.synchronize()
    return out


def _counters():
    return (GPV.encode.captures, GPV.encode.replays, GPV.encode.eager_calls)


def _same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("name", list(DETECTORS))
@pytest.mark.parametrize("B", [1, 8, 20])
def test_graphed_encode_equals_eager(engines, name, B):
    engine = engines(name)
    model = engine.model
    inputs = _device_inputs(engine, B, seed=B)
    encode_graph.drop(model)
    with eager():
        want = _encode(model, inputs)
    steps = []
    for _ in range(4):
        before = _counters()
        got = _encode(model, inputs)
        steps.append(tuple(a - b for a, b in zip(_counters(), before)))
        _same(got, want)
    # eager, capture (and its replay), replay, replay
    assert steps == [(0, 0, 1), (1, 1, 0), (0, 1, 0), (0, 1, 0)]
    images, queries = _batch(B, seed=B + 1)
    with eager():
        want = engine.predict(images, queries)
    for _ in range(3):
        got = engine.predict(images, queries)
    for g, w in zip(got, want):
        assert g["answer"] == w["answer"]
        assert np.array_equal(g["boxes"], w["boxes"])
        assert np.array_equal(g["relevance"], w["relevance"])


def test_a_forward_hook_fires_after_a_capture(engines):
    engine = engines("deform")
    model = engine.model
    inputs = _device_inputs(engine, 8, seed=3)
    for _ in range(2):
        _encode(model, inputs)
    layer = model.detr.transformer.encoder.layers[0].self_attn
    fired = []
    handle = layer.register_forward_hook(
        lambda mod, args, out: fired.append(out.shape))
    try:
        before = _counters()
        got = _encode(model, inputs)
        assert _counters() == (before[0], before[1], before[2] + 1)
        assert len(fired) == 1
    finally:
        handle.remove()
    before = _counters()
    _same(_encode(model, inputs), got)
    assert _counters() == (before[0], before[1] + 1, before[2])


def test_two_threads_predict_at_once(engines):
    engine = engines("r50")
    cases = [_batch(8, 30), _batch(20, 31)]
    want = []
    for images, queries in cases:   # each key captured on this thread
        for _ in range(3):
            out = engine.predict(images, queries)
        want.append(out)
    results, errors = {}, []

    def work(k):
        try:
            results[k] = [engine.predict(*cases[k]) for _ in range(4)]
        except Exception as e:  # pragma: no cover - reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(k,)) for k in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    for k, outs in results.items():
        for out in outs:
            for g, w in zip(out, want[k]):
                assert g["answer"] == w["answer"]
                assert np.array_equal(g["boxes"], w["boxes"])
                assert np.array_equal(g["relevance"], w["relevance"])


def _launches():
    return (A.fused_attention.variant_launches["tile"]
            + A.fused_biattention.variant_launches["tile"],
            ms_deform_attn.variant_launches["bf16"])


@pytest.mark.parametrize("name", ["r50", "deform"])
def test_counted_launches_equal_the_traced_kernels(engines, name):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    engine = engines(name)
    model = engine.model
    inputs = _device_inputs(engine, 20, seed=40)
    for _ in range(2):
        _encode(model, inputs)
    before, replays = _launches(), GPV.encode.replays
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _encode(model, inputs)
        x = torch.zeros(1, device="cuda")
        for _ in range(256):   # the profiler loses the last records
            x.add_(1)
        torch.cuda.synchronize()
        time.sleep(0.05)
    assert GPV.encode.replays == replays + 1
    counted = tuple(a - b for a, b in zip(_launches(), before))
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    traced = (sum(1 for n in names if "gpv_attn_tile_kernel" in n
                  or "gpv_attn_tile_bi_kernel" in n),
              sum(1 for n in names if "gpv_msdeform_bf16_kernel" in n))
    assert counted == traced
    assert counted[0] > 0 and (counted[1] > 0) == (name == "deform")


def test_to_after_a_capture_gives_right_outputs(engines):
    engine = engines("r50")
    model = engine.model
    inputs = _device_inputs(engine, 8, seed=50)
    for _ in range(2):
        _encode(model, inputs)
    captures = GPV.encode.captures
    model.cpu()
    model.cuda()
    torch.cuda.synchronize()
    with eager():
        want = _encode(model, inputs)
    for _ in range(3):
        got = _encode(model, inputs)
    assert GPV.encode.captures == captures + 1
    _same(got, want)


def test_memory_reserved_constant_from_the_third_predict(engines):
    engine = engines("r50")
    images, queries = _batch(20, 60)
    encode_graph.drop(engine.model)

    def call():
        out = engine.predict(images, queries)
        torch.cuda.synchronize()
        return [r["answer"] for r in out]

    first = [call() for _ in range(3)]
    reserved = torch.cuda.memory_reserved()
    later = [call() for _ in range(3)]
    assert torch.cuda.memory_reserved() == reserved
    assert all(a == first[0] for a in first + later)
