"""What a traced run records and the arithmetic that reduces it.

A traced run (`--trace 1`) keeps host spans from the benchmark's own
wrappers around the program's layers (`Spans`), and one `torch.profiler`
window of device activity over a steady stretch of the measured window
(`Profile`). The per-layer readers under `metrics/` take a `TraceData`.

Busy time is the union of the device's kernel, copy and set intervals:
work on two streams at once, or a copy beside a kernel, counts once.
Kernel groups come from name fragments in data files under `kernels/`:
`kernels/<kind>-<name>.json` holds `fragments` of the device kernels that
do one kind of work, and, for a hand kernel of the program, its counted
`variants` and the program functions whose `variant_launches` count them
(`counters`, as "module:function").
"""
from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

KERNELS = Path(__file__).resolve().parent / "kernels"
FIRST_KINDS = ("attention", "conv", "gemm", "copy")

Interval = Tuple[float, float]


def union_seconds(intervals: Sequence[Interval]) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def idle_gaps(intervals: Sequence[Interval], lo: float,
              hi: float) -> List[Interval]:
    """The stretches of [lo, hi) that no interval covers."""
    gaps, end = [], lo
    for a, b in sorted(intervals):
        if a > end:
            gaps.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        gaps.append((end, hi))
    return [g for g in gaps if g[1] > g[0]]


class Spans:
    """Host spans (name, start, end) in `time.perf_counter` seconds, kept in
    memory; `wrap` times a callable, ending the span once the device has
    finished what the call enqueued."""

    def __init__(self, sync=None):
        self.sync = sync
        self.records: List[Tuple[str, float, float]] = []
        self._lock = threading.Lock()

    def wrap(self, name: str, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if self.sync is not None:
                self.sync()
            with self._lock:
                self.records.append((name, t0, time.perf_counter()))
            return out
        return timed

    def durations(self, name: str) -> List[float]:
        return [b - a for n, a, b in self.records if n == name]


@dataclass
class DeviceEvent:
    name: str
    start: float   # seconds on the host's perf_counter clock
    end: float


@dataclass
class Profile:
    """One profiler window: device events, its host bounds, and what the
    driver counted inside it (calls, images, the program's counters)."""
    events: List[DeviceEvent]
    t0: float
    t1: float
    counts: Dict[str, float] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_s(self) -> float:
        return union_seconds([(max(e.start, self.t0), min(e.end, self.t1))
                              for e in self.events
                              if e.end > self.t0 and e.start < self.t1])


@dataclass
class TraceData:
    """Everything a per-layer reader may read."""
    model: dict
    spans: Spans
    profile: Optional[Profile]
    counts: Dict[str, float] = field(default_factory=dict)


def _kind(path: Path) -> str:
    return path.stem.split("-", 1)[0]


def kinds() -> Tuple[str, ...]:
    """Every kind of work a `kernels/<kind>-*.json` defines: the attention,
    convolution, matrix product and copy groups first, then the others
    sorted (a kernel is grouped by the first whose fragments match)."""
    found = {_kind(path) for path in KERNELS.glob("*-*.json")}
    return FIRST_KINDS + tuple(sorted(found - set(FIRST_KINDS)))


def patterns(kind: str) -> Dict[str, List[str]]:
    """{file stem: name fragments} of every `kernels/<kind>-*.json`: the
    device kernels that do one kind of work."""
    out = {}
    for path in sorted(KERNELS.glob(f"{kind}-*.json")):
        out[path.stem] = list(json.loads(path.read_text())["fragments"])
    return out


def variants(kind: str) -> Dict[str, List[str]]:
    """{program counter: name fragments} of the `variants` of every
    `kernels/<kind>-*.json`: which device kernels one counted launch of
    the program runs as."""
    out: Dict[str, List[str]] = {}
    for path in sorted(KERNELS.glob(f"{kind}-*.json")):
        out.update(json.loads(path.read_text()).get("variants", {}))
    return out


def counters() -> Dict[str, List[str]]:
    """{kind: program functions ("module:function")} of every kind whose
    `kernels/<kind>-*.json` name `counters`: each function's
    `variant_launches` counts its launches by variant, under the variant
    names `<function>.<variant>`."""
    out: Dict[str, List[str]] = {}
    for path in sorted(KERNELS.glob("*-*.json")):
        names = json.loads(path.read_text()).get("counters", [])
        if names:
            out.setdefault(_kind(path), []).extend(names)
    return out


def launch_gaps(events: Sequence["DeviceEvent"], counted: Dict[str, int],
                kind: str) -> List[str]:
    """Where a trace's kernels of `kind` differ from the launches the
    program counted over its window (`counted`: {counter: launches}): a
    counted launch that no data file names, or a variant traced more or
    fewer times than counted (the profiler lost records, or a kernel runs
    under another name). Empty when every launch is in the trace."""
    table = variants(kind)
    gaps = [f"{n} launches of {v}, which no kernels/{kind}-*.json names"
            for v, n in counted.items() if n and v not in table]
    for v, frags in table.items():
        n = sum(1 for e in events if matches(e.name, frags))
        if n != counted.get(v, 0):
            gaps.append(f"{v}: {n} traced, {counted.get(v, 0)} launched")
    return gaps


def matches(name: str, fragments: Sequence[str]) -> bool:
    low = name.lower()
    return any(f.lower() in low for f in fragments)


def group_of(name: str, table: Dict[str, List[str]]) -> str:
    """The first group (in `kinds()` order, as `group_table` holds them)
    whose fragments match, else "elementwise": every kernel of no kind a
    data file defines."""
    for g, frags in table.items():
        if matches(name, frags):
            return g
    return "elementwise"


def group_table() -> Dict[str, List[str]]:
    """{kind: name fragments} in `kinds()` order."""
    return {g: [f for frags in patterns(g).values() for f in frags]
            for g in kinds()}


def profiler(device_type: str):
    """A `torch.profiler.profile` of the device's activity (the CPU's on
    the CPU, where there is no device)."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA if device_type == "cuda"
                               else ProfilerActivity.CPU])


def warm_profiler(device_type: str) -> None:
    """Start and stop the profiler once in set-up: its first start in a
    process (CUPTI's) takes seconds, which would eat the traced window."""
    import torch
    with profiler(device_type):
        torch.ones(8, device=device_type).add_(1)
        if device_type == "cuda":
            torch.cuda.synchronize()


def settle(device_type: str, kernels: int = 256) -> None:
    """Run a few hundred tiny kernels past the end of a profiled window,
    then wait, before the profiler stops: it has lost the last records of
    a window (about one call's worth of decode launches) when stopped at
    once, and these stand in the tail instead."""
    import torch
    if device_type != "cuda":
        return
    x = torch.zeros(1, device=device_type)
    for _ in range(kernels):
        x.add_(1)
    torch.cuda.synchronize()
    time.sleep(0.05)


def clock_offset() -> float:
    """Seconds to subtract from the profiler's wall-clock timestamps to put
    them on `time.perf_counter`'s clock."""
    return time.time() - time.perf_counter()


def read_profile(prof, offset: float) -> List[DeviceEvent]:
    """Device events (kernels, copies, sets) of a finished
    `torch.profiler.profile`, on the host's perf_counter clock (`offset`
    from `clock_offset`)."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        start = e.start_ns() * 1e-9 - offset
        out.append(DeviceEvent(e.name(), start,
                               start + e.duration_ns() * 1e-9))
    return out


def breakdown(events: List[DeviceEvent], spans: Spans, t0: float,
              t1: float, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by the innermost host span around each gap's middle."""
    by_name: Dict[str, float] = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.end - e.start)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = idle_gaps([(e.start, e.end) for e in events], t0, t1)
    named: Dict[str, float] = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        inside = [(e - s, n) for n, s, e in spans.records if s <= mid < e]
        label = min(inside)[1] if inside else "between calls"
        named[label] = named.get(label, 0.0) + (b - a)
    longest = sorted(named.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in longest]}
