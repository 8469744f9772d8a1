"""The readers of the program's spans (`gpvbench/spans.py` and the seven
`metrics/*` over it): each gives its hand-computed value on a synthetic
trace and nothing without program spans (an older program); the idle
breakdown names a gap by the innermost span, the program's or the
benchmark's; and a traced tiny run on the CPU gives every one a value
(its profiler turns the program's spans on)."""
from __future__ import annotations

import json
import math
from pathlib import Path

import pytest

from gpvbench.spans import breakdown, in_window
from gpvbench.tests.test_gpvbench_manifest import metric_module
from gpvbench.tests.tiny import run_tiny
from gpvbench.trace import DeviceEvent, Profile, Spans, TraceData
from gpv_tpu_torch.utils import profiling
from gpv_tpu_torch.utils.profiling import SpanRecord

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
MS = 1_000_000   # ns


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.drain()
    yield
    profiling.drain()


def rec(name, a_ms, b_ms, thread=1, cpu_ms=None):
    cpu = None if cpu_ms is None else (0, int(cpu_ms * MS))
    return SpanRecord(name, thread, int(a_ms * MS), int(b_ms * MS),
                      *(cpu or (None, None)))


def trace_of(recs, t0=0.0, t1=1.0):
    t = TraceData({}, Spans(), Profile([], t0, t1))
    t.program = list(recs)
    return t


# two predict calls inside the window [0, 1 s), one crossing its end
PREDICT = [
    rec("engine.tokenize", 10, 11), rec("engine.upload", 11, 14),
    rec("engine.encode", 14, 20), rec("decode.stop_wait", 22, 25),
    rec("decode.step", 20, 25), rec("decode.stop_wait", 27, 28),
    rec("decode.step", 25, 28), rec("engine.fetch", 28, 30),
    rec("engine.detokenize", 30, 31),
    rec("engine.tokenize", 100, 101), rec("engine.upload", 101, 106),
    rec("engine.encode", 106, 110), rec("decode.stop_wait", 112, 120),
    rec("decode.step", 110, 120), rec("engine.fetch", 120, 121),
    rec("engine.detokenize", 121, 122),
    rec("engine.tokenize", 990, 991), rec("engine.upload", 991, 1010)]
TRAIN = [
    rec("train.upload", 0, 30), rec("train.forward", 30, 80),
    rec("train.matcher.wait", 60, 70), rec("train.matcher.solve", 70, 74),
    rec("train.backward", 80, 100), rec("train.adamw", 105, 110),
    rec("train.upload", 200, 220), rec("train.forward", 220, 260),
    rec("train.matcher.solve", 250, 256), rec("train.adamw", 300, 302),
    rec("train.upload", 995, 1005)]
SERVE = ([rec("serve.queue", i, i + 10 * (i + 1), thread=7)
          for i in range(20)]
         + [rec("serve.queue", 1001, 1100, thread=7),
            rec("engine.tokenize", 200, 210, 7, cpu_ms=8),
            rec("engine.encode", 210, 230, 7, cpu_ms=10),
            rec("decode.step", 230, 250, 7, cpu_ms=12),
            rec("decode.stop_wait", 240, 250, 7, cpu_ms=2),
            rec("engine.fetch", 250, 260, 7, cpu_ms=1),
            rec("engine.detokenize", 260, 270, 8, cpu_ms=10)])

CASES = {
    # ms a call: (3 + 5) / 2 calls
    "upload_ms.predict": (PREDICT, 4.0),
    # (5 - 3) + (3 - 1) + (10 - 8), over 2 calls
    "decode_launch_ms.predict": (PREDICT, 3.0),
    # waits 3 + 1 + 8, fetches 2 + 1, over 2 calls
    "host_wait_ms.predict": (PREDICT, 7.5),
    "upload_ms.train": (TRAIN, 25.0),
    "matcher_ms.train": (TRAIN, 5.0),
    # queue waits 10, 20, ..., 200 ms; numpy's 95th percentile: 190.5
    "queue_wait_ms.serve": (SERVE, 190.5),
    # wall 10 + 20 + (20 - 10) + 10 = 50, CPU 8 + 10 + (12 - 2) + 10 = 38
    "enqueue_offcpu_pct.serve": (SERVE, 24.0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_by_hand(name):
    recs, want = CASES[name]
    mod = metric_module(name)
    assert mod.read(trace_of(recs)) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_reads_nothing_without_program_spans(name, monkeypatch):
    mod = metric_module(name)
    assert mod.read(trace_of([])) is None
    # an older program: no spans to drain at all
    monkeypatch.delattr(profiling, "drain")
    assert mod.read(trace_of([])) is None


def test_the_new_metrics_are_the_manifests():
    entries = {m["name"]: m for m in MAN["per_layer"]}
    for name in CASES:
        m = entries[name]
        assert m["source"] == "program_span" and m["better"] == "lower"
        assert m["workloads"]


def test_records_are_taken_once_and_kept_for_every_reader():
    profiling.enable()
    with profiling.span("engine.upload"):
        pass
    profiling.disable()
    t = TraceData({}, Spans(), Profile([], 0.0, 1e12))
    assert [r.name for r in in_window(t)] == ["engine.upload"]
    assert profiling.drain() == []
    assert [r.name for r in in_window(t)] == ["engine.upload"]


def test_breakdown_names_a_gap_by_the_innermost_span_of_either_kind():
    spans = Spans()
    spans.records += [("predict", 0.0, 10.0), ("decode", 4.0, 9.0)]
    recs = [r for r in in_window(trace_of([
        rec("engine.upload", 500, 1500), rec("decode.step", 5000, 6000),
        rec("decode.stop_wait", 5200, 5900)], 0.0, 10.0))]
    events = [DeviceEvent("k", 1.6, 4.0), DeviceEvent("k", 4.5, 5.1),
              DeviceEvent("k", 6.0, 10.0)]
    out = breakdown(events, spans, recs, 0.0, 10.0)
    assert dict(out["idle_gaps"]) == pytest.approx(
        # [0, 1.6): upload (the program's, inside `predict`);
        # [4, 4.5): `decode` (the benchmark's); [5.1, 6): stop_wait
        {"engine.upload": 1.6, "decode": 0.5, "decode.stop_wait": 0.9})
    assert dict(breakdown(events, spans, None, 0.0, 10.0)["idle_gaps"]) \
        == pytest.approx({"predict": 1.6, "decode": 1.4})


@pytest.mark.parametrize("cell", ["predict-greedy-r50", "train-4task-r50",
                                  "serve-open-r50"])
def test_a_traced_tiny_run_gives_every_new_metric(cell):
    out = run_tiny(cell, seed=2 ** 31 + 3, trace=True)
    new = [m["name"] for m in MAN["per_layer"]
           if m["name"] in CASES and cell in m["workloads"]]
    assert new
    for name in new:
        assert math.isfinite(out["metrics"][name]["value"]), name
