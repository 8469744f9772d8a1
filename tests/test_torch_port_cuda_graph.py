"""The CUDA-graph plumbing below the kernels (`gpv_tpu_torch.ops._cuda`,
`ops.cuda_graph`) on the CPU, for each of its two users, the greedy
decode's step (`decode.greedy`) and the model encode
(`models.encode_graph`):

- the hand-written kernels' launches counted while a thread captures go
  to the capture's tally and not to the counters (another thread counts
  as usual), and each replay of the graph adds the tally;
- the kernel and graph counters lose no update across threads.

The graphs themselves run on the card only:
tests/test_torch_port_decode_graph_card.py and
tests/test_torch_port_encode_graph_card.py."""
import sys
import threading
import types
from collections import Counter

import pytest
import torch

import test_torch_port_decode_graph as dec
import test_torch_port_encode_graph as enc
from gpv_tpu_torch.decode.greedy import greedy_decode
from gpv_tpu_torch.models.gpv import GPV
from gpv_tpu_torch.ops import _cuda
from gpv_tpu_torch.ops import attention as A
from gpv_tpu_torch.ops.cuda_graph import Graph
from gpv_tpu_torch.ops.ms_deform_attn import ms_deform_attn
from test_torch_port_encode_graph import stand_in  # noqa: F401 (fixture)

FA, FB, MD = A.fused_attention, A.fused_biattention, ms_deform_attn
# the hand-written kernels' launches of what each user captures: K1's in a
# decode step; K1's and K2's tile variants and the deformable sampling in
# an encode
LAUNCHES = {"decode": [(FA, "decode"), (FA, "tile"), (FA, "decode")],
            "encode": [(FA, "tile"), (FB, "tile"), (MD, "bf16"),
                       (MD, "bf16")]}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def saved_launches():
    """The kernel counters, restored after the test."""
    saved = {fn: (fn.launches, dict(fn.variant_launches))
             for fn in (FA, FB, MD)}
    yield saved
    for fn, (launches, variants) in saved.items():
        fn.launches, fn.variant_launches = launches, variants


@pytest.mark.parametrize("kind", ["decode", "encode"])
def test_launches_counted_while_capturing_go_to_the_capture_tally(
        kind, saved_launches):
    launches = LAUNCHES[kind]
    tally, other = {}, threading.Event()

    def elsewhere():  # another thread counts as usual meanwhile
        _cuda.count_launch(*launches[0])
        other.set()

    with _cuda.count_into(tally):
        for fn, variant in launches:
            _cuda.count_launch(fn, variant)
        worker = threading.Thread(target=elsewhere)
        worker.start()
        worker.join(timeout=30)
    assert other.is_set() and not worker.is_alive()
    assert tally == dict(Counter(launches))
    for fn, (n, variants) in saved_launches.items():
        assert fn.launches == n + (fn is launches[0][0])
    graph = Graph(types.SimpleNamespace(replay=lambda: None), None, tally)
    graph.replay()
    graph.replay()
    for fn, (n, variants) in saved_launches.items():
        mine = {v: k for (f, v), k in tally.items() if f is fn}
        first = fn is launches[0][0]
        assert fn.launches == n + first + 2 * sum(mine.values())
        for variant, k in variants.items():
            assert fn.variant_launches[variant] == k + 2 * mine.get(
                variant, 0) + (first and variant == launches[0][1])


def _decode_work(request):
    """Threads decoding on the host: (their work, the graph counters, what
    four threads add to them)."""
    model, (memory, valid) = dec._model(), dec._memory(3)

    def work():
        for _ in range(3):
            greedy_decode(model, memory, valid, cls_id=1)
    return work, greedy_decode, {"eager_steps": 4 * 3 * (dec.T - 1)}


def _encode_work(request):
    """Threads taking the graphed encode path (stood in) over a few keys:
    each key is seen once, captured once and replayed by every other
    call."""
    model = enc._model()
    keys = [enc._inputs(masks=False, batch=b) for b in (1, 2, 3)]
    log = request.getfixturevalue("stand_in")

    def work():
        with torch.inference_mode():
            for inputs in keys * 2:
                model.encode(*inputs)
        assert len(log) <= len(keys)
    return work, GPV.encode, {"captures": len(keys),
                              "eager_calls": len(keys),
                              "replays": 4 * 2 * len(keys) - len(keys)}


@pytest.mark.parametrize("kind", ["decode", "encode"])
def test_counters_lose_no_update_across_threads(kind, request,
                                                saved_launches):
    """The user's own threads, beside threads counting kernel launches
    into capture tallies and replaying them, threads counting launches
    directly and threads counting graph replays directly, with the
    interpreter switching threads often: every count lands once."""
    work, counters, adds = {"decode": _decode_work,
                            "encode": _encode_work}[kind](request)
    names = ("captures", "replays", "eager_steps" if kind == "decode"
             else "eager_calls")
    before = {name: getattr(counters, name) for name in names}
    variant, n, errors = LAUNCHES[kind][0][1], 200, []

    def capture_and_replay():
        tally = {}
        with _cuda.count_into(tally):
            _cuda.count_launch(FA, variant)
        graph = Graph(types.SimpleNamespace(replay=lambda: None), None,
                      tally)
        for _ in range(n):
            graph.replay()

    def count_launches():
        for _ in range(n):
            _cuda.count_launch(FA, variant)

    def count_replays():
        for _ in range(n):
            _cuda.count(counters, "replays")

    def guarded(fn):
        def run():
            try:
                fn()
            except Exception as e:  # reported by the assert below
                errors.append(e)
        return run

    jobs = [capture_and_replay, count_launches, count_replays, work] * 4
    threads = [threading.Thread(target=guarded(fn)) for fn in jobs]
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(saved)
    assert not errors and not any(t.is_alive() for t in threads)
    adds["replays"] = adds.get("replays", 0) + 4 * n
    for name in names:
        assert getattr(counters, name) == before[name] + adds.get(name, 0), \
            name
    launches, variants = saved_launches[FA]
    assert FA.launches == launches + 8 * n
    assert FA.variant_launches[variant] == variants[variant] + 8 * n
