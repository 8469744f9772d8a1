"""The model encode's graphed path (`gpv_tpu_torch.models.encode_graph`,
`GPV.encode`) on the CPU, where nothing is captured:

- when a call may replay a graph: never on the CPU, with a gradient, with
  `query_enc`, on a sharded model, under torch.export, or with a forward
  hook or pre-hook on any module (or a global one);
- the key, which changes with every shape, stride, dtype, mask presence
  and mode;
- the body (`GPV._encode`) against `GPV.encode`, bit for bit, for the
  DETR and the Deformable DETR detector;
- the keys' bookkeeping with the card's capture and replay stood in for:
  eager first, captured second, replayed after, at most `MAX_GRAPHS`
  graphs, dropped by `.to()`.

The graph itself runs on the card only:
tests/test_torch_port_encode_graph_card.py; the counters across threads
and while a thread captures: tests/test_torch_port_cuda_graph.py."""
import threading
import types

import pytest
import torch
from torch import nn

from gpv_tpu_torch.models import encode_graph
from gpv_tpu_torch.models.gpv import GPV
from gpv_tpu_torch.ops._cuda import traced
from gpv_tpu_torch.parallel.tensor_parallel import ModelGroup
from gpv_tpu_torch.weights import init_random

CUDA = torch.device("cuda")   # a device object; nothing runs on it here
B, H, W, TL, D = 2, 64, 96, 6, 32
HOOKED = ["", "detr", "detr.backbone.0.body.conv1", "bert.model.encoder",
          "co_att_transformer.0", "relevance_predictor"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(detector="detr"):
    detr = dict(num_queries=5, hidden_dim=D, nheads=4, num_encoder_layers=1,
                num_decoder_layers=1, dim_feedforward=64,
                backbone_layers=(1, 1, 1, 1))
    if detector == "deformable_detr":
        detr.update(num_feature_levels=4, enc_n_points=2, dec_n_points=2)
    model = GPV(vocab_size=40, hidden_dim=D, max_text_len=8,
                co_att_num_layers=1, co_att_heads=4, co_att_intermediate=64,
                text_decoder_layers=1, text_decoder_heads=4, detr_cfg=detr,
                bert_layers=1, bert_hidden=D, bert_heads=4,
                bert_vocab_size=100, bert_max_len=16, detector=detector)
    init_random(model, seed=3)
    return model.eval()


@pytest.fixture(scope="module")
def model():
    return _model()


def _inputs(masks=True, seed=0, batch=B):
    g = torch.Generator().manual_seed(seed)
    images = torch.randn(batch, H, W, 3, generator=g)
    ids = torch.randint(1, 100, (batch, TL), generator=g)
    if not masks:
        return images, ids, None, None
    image_valid = torch.ones(batch, H, W, dtype=torch.bool)
    image_valid[0, :, W // 2:] = False
    query_valid = torch.ones(batch, TL, dtype=torch.bool)
    query_valid[-1, TL - 2:] = False
    return images, ids, image_valid, query_valid


def _counters():
    return (GPV.encode.captures, GPV.encode.replays, GPV.encode.eager_calls)


def _same(a, b):
    (ma, va, oa), (mb, vb, ob) = a, b
    assert torch.equal(ma, mb)
    assert (va is None and vb is None) or torch.equal(va, vb)
    assert oa.keys() == ob.keys()
    for name in oa:
        assert torch.equal(oa[name], ob[name]), name


# ------------------------------------------------------- when it graphs

@pytest.mark.parametrize("case", ["card", "cpu", "grad", "query_enc",
                                  "sharded", "traced"])
def test_graphable_only_on_a_card_without_grad_query_enc_or_tracing(
        model, case):
    device = torch.device("cpu") if case == "cpu" else CUDA
    query_enc = torch.zeros(B, TL, D) if case == "query_enc" else None
    if case == "sharded":
        model.tp = ModelGroup(None, 0, 2)
    try:
        with torch.set_grad_enabled(case == "grad"):
            got = encode_graph.graphable(model, device, query_enc,
                                         case == "traced")
    finally:
        model.tp = None
    assert got is (case == "card")


def test_no_graph_under_torch_export(model):
    seen = []

    class Probe(nn.Module):
        def forward(self, x):
            seen.append(encode_graph.graphable(model, CUDA, None,
                                               traced(x)))
            return x + 1

    x = torch.ones(3)
    with torch.no_grad():
        assert encode_graph.graphable(model, CUDA, None, traced(x))
        torch.export.export(Probe(), (x,))
    assert seen and not any(seen)


@pytest.mark.parametrize("kind", ["forward", "pre"])
@pytest.mark.parametrize("where", HOOKED + ["global"])
def test_a_forward_hook_anywhere_keeps_encode_eager(model, kind, where):
    def hook(*args):
        return None

    if where == "global":
        register = (nn.modules.module.register_module_forward_hook
                    if kind == "forward"
                    else nn.modules.module.register_module_forward_pre_hook)
    else:
        mod = model.get_submodule(where)
        register = (mod.register_forward_hook if kind == "forward"
                    else mod.register_forward_pre_hook)
    with torch.no_grad():
        assert encode_graph.graphable(model, CUDA, None, False)
        handle = register(hook)
        try:
            assert not encode_graph.graphable(model, CUDA, None, False)
        finally:
            handle.remove()
        assert encode_graph.graphable(model, CUDA, None, False)


# ------------------------------------------------------------------ key

def _variants():
    """(name, the inputs and train of a call whose key differs from the
    base call's)."""
    base = _inputs()
    images, ids, iv, qv = base
    return [
        ("batch", _inputs(batch=B + 1), False),
        ("image size", (images[:, :H - 8], ids, iv[:, :H - 8], qv), False),
        ("query length", (images, ids[:, :-1], iv, qv[:, :-1]), False),
        ("image dtype", (images.to(torch.bfloat16), ids, iv, qv), False),
        ("ids dtype", (images, ids.int(), iv, qv), False),
        ("image stride", (images.transpose(1, 2).contiguous()
                          .transpose(1, 2), ids, iv, qv), False),
        ("no image mask", (images, ids, None, qv), False),
        ("no query mask", (images, ids, iv, None), False),
        ("no masks", (images, ids, None, None), False),
        ("train", base, True),
    ]


def test_key_changes_with_each_shape_dtype_mask_and_mode():
    base = _inputs()
    want = encode_graph.key(base, False)
    assert encode_graph.key(_inputs(seed=1), False) == want
    keys = {want}
    for name, inputs, train in _variants():
        k = encode_graph.key(inputs, train)
        assert k not in keys, name
        keys.add(k)
    with torch.inference_mode():
        assert encode_graph.key(base, False) not in keys


# ---------------------------------------------------- the body is encode

@pytest.mark.parametrize("detector", ["detr", "deformable_detr"])
@pytest.mark.parametrize("masks", [True, False])
def test_body_equals_encode_on_the_cpu(detector, masks):
    model = _model(detector)
    inputs = _inputs(masks)
    with torch.inference_mode():
        before = _counters()
        got = model.encode(*inputs)
        assert _counters() == (before[0], before[1], before[2] + 1)
        want = model._encode(*inputs)
    _same(got, want)
    assert got[0].shape[1] == 5 + TL


# ---------------------------------------- the keys' bookkeeping, stood in

@pytest.fixture
def stand_in(monkeypatch):
    """`GPV.encode` on the CPU with the card's parts stood in for: every
    call may graph; a capture records its key's inputs and a replay runs
    the body on the call's own inputs. Yields the captures' log."""
    class Device:   # encode_graph._Device's parts that `encode` reads
        lock = threading.Lock()
        done = types.SimpleNamespace(synchronize=lambda: None)

    dev, log = Device(), []

    def capture(model, inputs, train, dev):
        log.append(tuple(t.shape for t in inputs if t is not None))
        return model

    monkeypatch.setattr(encode_graph, "graphable", lambda *a: True)
    monkeypatch.setattr(encode_graph, "_device", lambda device: dev)
    monkeypatch.setattr(encode_graph, "_capture", capture)
    monkeypatch.setattr(encode_graph, "_replay",
                        lambda graph, inputs, dev: graph._encode(*inputs))
    yield log


def test_second_call_of_a_key_captures_and_later_calls_replay(stand_in):
    model = _model()
    inputs = _inputs()
    with torch.inference_mode():
        want = model._encode(*inputs)
        before = _counters()
        got = [model.encode(*inputs) for _ in range(4)]
    assert _counters() == (before[0] + 1, before[1] + 3, before[2] + 1)
    assert len(stand_in) == 1
    for out in got:
        _same(out, want)


def test_at_most_max_graphs_keys_are_kept(stand_in):
    model = _model()
    n = encode_graph.MAX_GRAPHS + 1
    calls = [_inputs(batch=b) for b in range(1, n + 1)]
    with torch.inference_mode():
        for inputs in calls:          # seen once: eager
            model.encode(*inputs)
        assert not stand_in
        for inputs in calls[1:]:      # seen twice: captured
            model.encode(*inputs)
        assert len(stand_in) == n - 1
        before = _counters()
        model.encode(*calls[0])       # forgotten among the keys seen once
        assert _counters()[2] == before[2] + 1 and len(stand_in) == n - 1
        model.encode(*calls[0])       # captured: the oldest graph goes
        assert len(stand_in) == n
        model.encode(*calls[1])       # dropped: seen anew, eager
        assert _counters()[2] == before[2] + 2
        for inputs in calls[2:]:      # still kept: replayed
            model.encode(*inputs)
        assert len(stand_in) == n
    graphs = encode_graph._models[model].graphs
    assert [len(g) for g in graphs.values()] == [encode_graph.MAX_GRAPHS]


def test_to_drops_the_graphs(stand_in):
    model = _model()
    inputs = _inputs()
    with torch.inference_mode():
        model.encode(*inputs)
        model.encode(*inputs)
    assert len(stand_in) == 1 and model in encode_graph._models
    model.to(torch.float32)
    assert model not in encode_graph._models
    with torch.inference_mode():
        model.encode(*inputs)          # eager again, then captured again
        model.encode(*inputs)
    assert len(stand_in) == 2
