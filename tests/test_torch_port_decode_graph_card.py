"""The greedy decode's CUDA graph (`gpv_tpu_torch.decode.greedy`) on the
card, at the released GPV's widths (hidden 768, text decoder 3 x 8 heads,
20 text positions) with a 10000-word answer vocabulary, in bf16:

- the graphed decode against the eager loop at B = 1, 8 and 20, with and
  without a vocab mask, with no stop id, a stop id that ends the decode
  early and one no row emits: tokens, logits and steps identical;
- the first decode of the process is graphed (nothing warmed before it);
- two threads decoding at once on one model, one on the default stream
  and one on a stream of its own, as `GPVServer`'s workers do through
  `GPVEngine`;
- K1's counted launches over a graphed call equal to the `decode`
  kernels in a torch.profiler trace of it;
- a `GPVEngine.predict` of 20 480x640 images: answers equal to the eager
  loop's, the allocator's peak over encode and decode no higher, and the
  memory reserved unchanged over further calls (each capture takes the
  last one's pool).

Card only: every test is marked `cuda` and skips without a CUDA device.
The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda \
        tests/test_torch_port_decode_graph_card.py
"""
import contextlib
import threading
import time

import numpy as np
import pytest
import torch

from gpv_tpu_torch.decode import greedy
from gpv_tpu_torch.decode.greedy import greedy_decode
from gpv_tpu_torch.engine import GPVEngine
from gpv_tpu_torch.models.gpv import GPV
from gpv_tpu_torch.ops import attention as A
from gpv_tpu_torch.text.vocab import AnswerVocab
from gpv_tpu_torch.text.wordpiece import WordPieceTokenizer
from gpv_tpu_torch.weights import init_random

VOCAB, TM, D = 10000, 120, 768
pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def engine():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    model = GPV(vocab_size=VOCAB)
    init_random(model, seed=7)
    return GPVEngine(model, AnswerVocab.debug(size=VOCAB),
                     WordPieceTokenizer.debug(), max_query_len=20,
                     device="cuda", dtype=torch.bfloat16)


@contextlib.contextmanager
def eager_loop():
    """Every decode in the block runs its step eagerly, as a call that
    cannot be graphed does."""
    saved = greedy._graphable
    greedy._graphable = lambda *a: False
    try:
        yield
    finally:
        greedy._graphable = saved


def _memory(B, seed, groups=None):
    """(B, 120, 768) bf16 memory and its validity; with `groups`, rows
    repeat `groups` distinct memories under a little noise, so that they
    decode alike."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = groups or B
    base = torch.randn(n, TM, D, device="cuda", generator=g)
    idx = torch.arange(B, device="cuda") % n
    memory = base[idx] + (0.01 if groups else 0.0) * torch.randn(
        B, TM, D, device="cuda", generator=g)
    valid = torch.rand(B, TM, device="cuda", generator=g) > 0.2
    valid[:, :100] = True   # the visual rows are always valid
    return memory.to(torch.bfloat16), valid


def _mask():
    mask = torch.zeros(VOCAB, device="cuda")
    mask[2::3] = -10000.0
    return mask


def _decode(model, memory, valid, mask, stop_id):
    return greedy_decode(model, memory, valid, 1, mask, stop_id=stop_id)


def _stop_ids(model, B, seed, mask):
    """Memory, its validity, a stop id that every row emits before the
    last step and one that no row emits, from eager decodes with
    rows alike in ever fewer groups."""
    for groups in (None, 4, 2, 1):
        memory, valid = _memory(B, seed, groups)
        with eager_loop():
            tok, _, _ = _decode(model, memory, valid, mask, None)
        first = {}
        for i in torch.unique(tok).tolist():
            hit = tok == i
            if bool(hit.any(1).all()):
                first[i] = int(hit.int().argmax(1).max())
        if first and min(first.values()) < tok.shape[1] - 1:
            seen = set(torch.unique(tok).tolist())
            never = next(i for i in range(VOCAB) if i not in seen)
            return memory, valid, min(first, key=first.get), never
    raise AssertionError("no row-wide token before the last step")


def test_first_decode_of_the_process_is_graphed(engine):
    model = engine.model
    memory, valid = _memory(8, 0)
    captures, replays = greedy_decode.captures, greedy_decode.replays
    got = _decode(model, memory, valid, None, None)
    assert greedy_decode.captures == captures + 1
    assert greedy_decode.replays == replays + got[2] == replays + 19
    with eager_loop():
        want = _decode(model, memory, valid, None, None)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("B", [1, 8, 20])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("stop", ["none", "early", "never"])
def test_graphed_decode_equals_the_eager_loop(engine, B, masked, stop):
    model = engine.model
    mask = _mask() if masked else None
    memory, valid, early, never = _stop_ids(model, B, 10 + B, mask)
    stop_id = {"none": None, "early": early, "never": never}[stop]
    before = (greedy_decode.captures, greedy_decode.replays,
              greedy_decode.eager_steps)
    got = _decode(model, memory, valid, mask, stop_id)
    after = (greedy_decode.captures, greedy_decode.replays,
             greedy_decode.eager_steps)
    assert after == (before[0] + 1, before[1] + got[2], before[2])
    with eager_loop():
        want = _decode(model, memory, valid, mask, stop_id)
    assert got[2] == want[2]
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    if stop == "early":
        assert got[2] < 19
    elif stop == "never":
        assert not bool((got[0] == stop_id).any()) and got[2] == 19


def test_two_threads_decode_at_once(engine):
    model = engine.model
    cases = [(_memory(8, 30), 8), (_memory(20, 31), 20)]
    torch.cuda.synchronize()   # the threads' streams read these
    results, errors = {}, []

    def work(k, own_stream):
        (memory, valid), _ = cases[k]
        try:
            ctx = torch.cuda.stream(torch.cuda.Stream()) if own_stream \
                else torch.cuda.stream(None)
            with ctx:
                outs = []
                for _ in range(6):
                    tok, logits, steps = _decode(model, memory, valid,
                                                 _mask(), None)
                    outs.append((tok.cpu(), logits.cpu(), steps))
            results[k] = outs
        except Exception as e:  # pragma: no cover - reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(0, False)),
               threading.Thread(target=work, args=(1, True))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    for k, ((memory, valid), _) in enumerate(cases):
        with eager_loop():
            tok, logits, steps = _decode(model, memory, valid, _mask(),
                                         None)
        for got in results[k]:
            assert got[2] == steps
            assert torch.equal(got[0], tok.cpu())
            assert torch.equal(got[1], logits.cpu())


def test_counted_launches_equal_the_traced_decode_kernels(engine):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    model = engine.model
    memory, valid = _memory(20, 40)
    _decode(model, memory, valid, None, None)
    before = A.fused_attention.variant_launches["decode"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, steps = _decode(model, memory, valid, None, None)
        torch.cuda.synchronize()
        x = torch.zeros(1, device="cuda")
        for _ in range(256):   # the profiler loses the last records
            x.add_(1)
        torch.cuda.synchronize()
        time.sleep(0.05)
    counted = A.fused_attention.variant_launches["decode"] - before
    traced = sum(1 for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and "gpv_attn_decode_kernel" in e.name)
    layers = len(model.text_decoder.layers)
    assert counted == traced == 2 * layers * steps


def test_engine_predict_memory_and_answers(engine):
    rng = np.random.RandomState(0)
    images = rng.randint(0, 255, (20, 480, 640, 3)).astype(np.uint8)
    queries = [f"what is the {w} doing next to the dog ?"
               for w in ("man", "cat", "horse", "person") * 5]

    def call():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = engine.predict(images, queries)
        torch.cuda.synchronize()
        return ([r["answer"] for r in out],
                torch.cuda.max_memory_allocated())

    graphed = [call() for _ in range(3)]
    reserved = torch.cuda.memory_reserved()
    graphed += [call() for _ in range(3)]
    assert torch.cuda.memory_reserved() == reserved
    with eager_loop():
        eager = [call() for _ in range(2)]
    assert graphed[-1][0] == eager[-1][0]
    assert graphed[-1][1] <= eager[-1][1], (graphed[-1][1], eager[-1][1])
