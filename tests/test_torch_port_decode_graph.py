"""The greedy decode's graphed path (`gpv_tpu_torch.decode.greedy`) on the
CPU, where nothing is captured: which calls take the host loop and what
they count, the step with its position as a 0-d tensor on the device
against the step with an int, the device-resident loop (the step a graph
captures, run here without capture) against the host loop, and the K1
launch counters while a thread captures.

The graph itself runs on the card only:
tests/test_torch_port_decode_graph_card.py."""
import threading

import pytest
import torch

from gpv_tpu_torch.decode import greedy
from gpv_tpu_torch.decode.greedy import greedy_decode
from gpv_tpu_torch.models.gpv import GPV
from gpv_tpu_torch.ops import attention as A
from gpv_tpu_torch.parallel.tensor_parallel import ModelGroup
from gpv_tpu_torch.weights import init_random

VOCAB, D, T, B, TM = 40, 32, 8, 3, 7


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(text_pos_enc=False):
    model = GPV(vocab_size=VOCAB, hidden_dim=D, max_text_len=T,
                text_pos_enc=text_pos_enc, co_att_num_layers=1,
                co_att_heads=4, co_att_intermediate=64,
                text_decoder_layers=2, text_decoder_heads=4,
                detr_cfg=dict(num_queries=5, hidden_dim=D, nheads=4,
                              num_encoder_layers=1, num_decoder_layers=1,
                              dim_feedforward=64,
                              backbone_layers=(1, 1, 1, 1)),
                bert_layers=1, bert_hidden=D, bert_heads=4,
                bert_vocab_size=100, bert_max_len=16)
    init_random(model, seed=5)
    return model.eval()


@pytest.fixture(scope="module")
def model():
    return _model()


def _memory(seed=0):
    g = torch.Generator().manual_seed(seed)
    memory = torch.randn(B, TM, D, generator=g)
    valid = torch.rand(B, TM, generator=g) > 0.3
    valid[:, 0] = True
    return memory, valid


def _counters():
    return (greedy_decode.captures, greedy_decode.replays,
            greedy_decode.eager_steps)


def _device_decode(model, memory, mem_valid, cls_id, vocab_mask=None,
                   stop_id=None):
    """`greedy_decode`'s device-resident loop with the step run as it is
    instead of captured (what a replay runs)."""
    with torch.inference_mode():
        mem_state = model.precompute_text_memory(memory)
        T1, n = model.max_text_len - 1, memory.shape[0]
        tokens = torch.full((n, T1), cls_id if stop_id is None else stop_id,
                            dtype=torch.int32)
        logits = torch.zeros(n, T1, model.vocab_size)
        steps = greedy._device_loop(
            model, mem_state, mem_valid, model.init_text_cache(n, "cpu"),
            torch.full((n,), cls_id, dtype=torch.long), tokens, logits,
            torch.zeros(n, dtype=torch.bool), vocab_mask, stop_id,
            capture=lambda step, device: step)
    return tokens, logits, steps


def test_cpu_call_takes_the_host_loop_and_counts_its_steps(model):
    memory, valid = _memory()
    before = _counters()
    _, _, steps = greedy_decode(model, memory, valid, cls_id=1)
    assert steps == T - 1
    assert _counters() == (before[0], before[1], before[2] + steps)


@pytest.mark.parametrize("attr", ["self_attn", "multihead_attn", "ffn"])
def test_a_sharded_decoder_takes_the_host_loop(model, attr):
    cuda = torch.device("cuda")
    assert greedy._graphable(model, cuda)
    assert not greedy._graphable(model, torch.device("cpu"))
    layer = model.text_decoder.layers[-1]
    group = ModelGroup(None, 0, 2)
    if attr == "ffn":
        layer.ffn_tp = group
    else:
        getattr(layer, attr).tp = group
    try:
        assert not greedy._graphable(model, cuda)
    finally:
        layer.ffn_tp = layer.self_attn.tp = layer.multihead_attn.tp = None


@pytest.mark.parametrize("text_pos_enc", [False, True])
def test_text_step_takes_its_position_as_a_device_scalar(text_pos_enc):
    model = _model(text_pos_enc)
    memory, valid = _memory(1)
    tok = torch.tensor([1, 4, 9])
    with torch.inference_mode():
        mem_state = model.precompute_text_memory(memory)
        c_int = model.init_text_cache(B, "cpu")
        c_dev = model.init_text_cache(B, "cpu")
        for t in range(T - 1):
            a = model.text_step(tok, mem_state, valid, c_int, t)
            b = model.text_step(tok, mem_state, valid, c_dev,
                                torch.tensor(t))
            assert torch.equal(a, b), t
            tok = a.argmax(-1)
    for (ki, vi), (kd, vd) in zip(c_int, c_dev):
        assert torch.equal(ki, kd) and torch.equal(vi, vd)


def _stop_ids(model, memory, valid, mask):
    """(a stop id every row emits before the last step, one no row
    emits) from an unstopped decode."""
    tokens, _, _ = greedy_decode(model, memory, valid, 1, mask)
    first = {}
    for i in range(VOCAB):
        hit = tokens == i
        if hit.any(1).all():
            first[i] = int(hit.int().argmax(1).max())
    early = min(first, key=first.get)
    never = next(i for i in range(VOCAB) if not (tokens == i).any())
    assert first[early] < T - 2
    return early, never


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("stop", ["none", "early", "never"])
def test_device_loop_equals_host_loop(model, masked, stop):
    memory, valid = _memory(1)
    mask = None
    if masked:
        mask = torch.zeros(VOCAB)
        mask[2::3] = -10000.0
    early, never = _stop_ids(model, memory, valid, mask)
    stop_id = {"none": None, "early": early, "never": never}[stop]
    want = greedy_decode(model, memory, valid, 1, mask, stop_id=stop_id)
    before = _counters()
    got = _device_decode(model, memory, valid, 1, mask, stop_id)
    assert _counters() == before
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert got[2] == want[2]
    assert got[2] < T - 1 if stop == "early" else got[2] == T - 1


def test_launches_counted_while_capturing_go_to_the_capture_tally():
    fa = A.fused_attention
    launches, decode = fa.launches, fa.variant_launches["decode"]
    tally, other = {}, threading.Event()

    def elsewhere():  # another thread counts as usual meanwhile
        A._count(fa, "decode")
        other.set()

    with A.count_into(tally):
        A._count(fa, "decode")
        A._count(fa, "tile")
        worker = threading.Thread(target=elsewhere)
        worker.start()
        worker.join(timeout=30)
        A._count(fa, "decode")
    assert other.is_set()
    assert tally == {(fa, "decode"): 2, (fa, "tile"): 1}
    assert (fa.launches, fa.variant_launches["decode"]) == (
        launches + 1, decode + 1)
    A.add_counts(tally)
    A.add_counts(tally)
    assert (fa.launches, fa.variant_launches["decode"]) == (
        launches + 7, decode + 5)
    fa.launches = launches
    fa.variant_launches["decode"] = decode
    fa.variant_launches["tile"] -= 2


def test_counters_lose_no_update_across_threads(model):
    """Threads decoding at once on the host, and threads counting K1
    launches into capture tallies and replaying them beside threads that
    count directly, with the interpreter switching threads often: every
    count lands once."""
    import sys
    fa = A.fused_attention
    memory, valid = _memory(3)
    eager, launches = greedy_decode.eager_steps, fa.launches
    decode, n, errors = fa.variant_launches["decode"], 200, []

    def capture_and_replay():
        tally = {}
        with A.count_into(tally):
            A._count(fa, "decode")
        for _ in range(n):
            A.add_counts(tally)

    def count_directly():
        for _ in range(n):
            A._count(fa, "decode")

    def decode_on_host():
        for _ in range(3):
            greedy_decode(model, memory, valid, cls_id=1)

    def guarded(fn):
        def run():
            try:
                fn()
            except Exception as e:  # reported by the assert below
                errors.append(e)
        return run

    work = [capture_and_replay, count_directly, decode_on_host] * 4
    threads = [threading.Thread(target=guarded(fn)) for fn in work]
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(saved)
    assert not errors and not any(t.is_alive() for t in threads)
    assert greedy_decode.eager_steps == eager + 4 * 3 * (T - 1)
    assert fa.launches == launches + 8 * n
    assert fa.variant_launches["decode"] == decode + 8 * n
    fa.launches, fa.variant_launches["decode"] = launches, decode
