"""The greedy decode's one loop (`gpv_tpu_torch.decode.greedy`) on the
CPU, where nothing is captured: which calls run the step eagerly and what
they count, the step with its position as a 0-d tensor on the device
against the teacher-forced decode, and the loop run through a stand-in
capture (what a replay runs) against the same loop run eagerly.

The graph itself runs on the card only:
tests/test_torch_port_decode_graph_card.py; the counters while a thread
captures: tests/test_torch_port_cuda_graph.py."""
import pytest
import torch

from gpv_tpu_torch.decode import greedy
from gpv_tpu_torch.decode.greedy import greedy_decode
from gpv_tpu_torch.models.gpv import GPV
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


def _captured_decode(model, memory, mem_valid, cls_id, vocab_mask=None,
                     stop_id=None):
    """`greedy_decode`'s loop with the step run through a stand-in capture
    (which runs the step it is given, as a replay runs what was captured),
    and how often the stand-in was called."""
    captured = []

    def capture_step(step, device):
        captured.append(device)
        return step

    with torch.inference_mode():
        mem_state = model.precompute_text_memory(memory)
        caches = model.init_text_cache(memory.shape[0], "cpu")
        logits = torch.zeros(memory.shape[0], model.max_text_len - 1,
                             model.vocab_size)
        tokens, steps = greedy.greedy_loop(
            lambda tok, t: model.text_step(tok, mem_state, mem_valid,
                                           caches, t),
            logits, cls_id, vocab_mask, stop_id, capture_step)
    return tokens, logits, steps, captured


def test_cpu_call_takes_the_eager_loop_and_counts_its_steps(model):
    memory, valid = _memory()
    before = _counters()
    _, _, steps = greedy_decode(model, memory, valid, cls_id=1)
    assert steps == T - 1
    assert _counters() == (before[0], before[1], before[2] + steps)


@pytest.mark.parametrize("attr", ["self_attn", "multihead_attn", "ffn"])
def test_a_sharded_decoder_takes_the_eager_loop(model, attr):
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
    """Each step at the 0-d position t gives the logits of the
    teacher-forced decode of the same tokens at t."""
    model = _model(text_pos_enc)
    memory, valid = _memory(1)
    ids = torch.tensor([[1, 4, 9, 2, 7, 7, 3, 5], [1, 0, 0, 6, 8, 1, 2, 3],
                        [1, 9, 5, 5, 4, 0, 6, 2]])[:, :T - 1]
    with torch.inference_mode():
        want = model.decode_text(model.embed_answer_tokens(ids), memory,
                                 valid)
        mem_state = model.precompute_text_memory(memory)
        caches = model.init_text_cache(B, "cpu")
        t = torch.zeros((), dtype=torch.long)
        for i in range(T - 1):
            got = model.text_step(ids[:, i], mem_state, valid, caches, t)
            torch.testing.assert_close(got, want[:, i], rtol=0, atol=1e-5)
            t.add_(1)


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
def test_captured_loop_equals_eager_loop(model, masked, stop):
    memory, valid = _memory(1)
    mask = None
    if masked:
        mask = torch.zeros(VOCAB)
        mask[2::3] = -10000.0
    early, never = _stop_ids(model, memory, valid, mask)
    stop_id = {"none": None, "early": early, "never": never}[stop]
    want = greedy_decode(model, memory, valid, 1, mask, stop_id=stop_id)
    before = _counters()
    *got, captured = _captured_decode(model, memory, valid, 1, mask,
                                      stop_id)
    assert _counters() == before
    assert captured == [torch.device("cpu")]
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert got[2] == want[2]
    assert got[2] < T - 1 if stop == "early" else got[2] == T - 1
