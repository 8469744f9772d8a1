"""Step timing, tracing and the program's spans (counterpart of
`gpv_tpu/utils/profiling.py`): `StepTimer` keeps rolling per-step wall
times; `start_trace`/`stop_trace` record a torch.profiler trace, CPU and,
on the card, CUDA activity, to `log_dir/trace.json` (Chrome trace
format): the trainer's `training.profile_step`; `trace(log_dir)` wraps
the two around a block.

Spans name the stages of the program's host paths (PERF.md §3 lists
them): `with span("engine.upload"): ...`. They record while `enable()`
is on or a torch.profiler is recording in this process, and are off
otherwise: `span` then returns one shared no-op context after reading
two flags (this module's and torch's profiler flag, a Python bool), with
no allocation, no clock read and no call into torch. A span
never synchronises the card; it brackets the syncs the program already
makes. While a profiler records, a span also opens
`torch.profiler.record_function(name)`, so the profiler's trace shows
the program's stages beside the kernels.

A record is (name, thread id, start, end, thread CPU at start, thread CPU
at end), all in ns: start and end on `time.perf_counter_ns`'s clock (the
span clock), CPU from `time.thread_time_ns` in a thread that asked for
it with `thread_cpu()` (the server's workers), else None: reading it is a
system call (3.6 us on the H100 machine, PERF.md §6), which made a
predict call 7% slower with a span's both ends reading it. `record` adds
a span that starts in one thread and ends in another (no CPU times).
Records go into one bounded process-wide buffer, so the stages of every
thread (the server's workers, an engine's shards) land in one place
without a lock (a deque's append is atomic); `drain` takes them out."""
from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from pathlib import Path
from threading import get_ident
from time import perf_counter_ns, thread_time_ns
from typing import List, NamedTuple, Optional

from torch.autograd import profiler as _torch_profiler

MAX_RECORDS = 1 << 17


class SpanRecord(NamedTuple):
    name: str
    thread: int
    start_ns: int
    end_ns: int
    cpu_start_ns: Optional[int]
    cpu_end_ns: Optional[int]


_on = False
_records: deque = deque(maxlen=MAX_RECORDS)
_OFF = contextlib.nullcontext()
_thread = threading.local()


def enable() -> None:
    """Record spans until `disable`."""
    global _on
    _on = True


def disable() -> None:
    """Stop recording spans (a recording profiler still turns them on)."""
    global _on
    _on = False


def thread_cpu(on: bool = True) -> None:
    """Have the calling thread's spans also read its CPU time at both
    ends (module docstring)."""
    _thread.cpu = on


def drain() -> List[SpanRecord]:
    """The records so far, oldest first; the buffer is left empty."""
    out = []
    while True:
        try:
            out.append(SpanRecord._make(_records.popleft()))
        except IndexError:
            return out


class _Span:
    __slots__ = ("name", "_fn", "_t0", "_c0")

    def __init__(self, name: str):
        self.name, self._fn = name, None

    def __enter__(self):
        if _torch_profiler._is_profiler_enabled:
            self._fn = _torch_profiler.record_function(self.name)
            self._fn.__enter__()
        self._c0 = thread_time_ns() if getattr(_thread, "cpu", False) \
            else None
        self._t0 = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = perf_counter_ns()
        _records.append((self.name, get_ident(), self._t0, t1, self._c0,
                         None if self._c0 is None else thread_time_ns()))
        if self._fn is not None:
            self._fn.__exit__(*exc)
        return False


def span(name: str):
    """A context that records the block as the span `name` (module
    docstring)."""
    if not (_on or _torch_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name)


def record(name: str, start_ns: int, end_ns: int) -> None:
    """Record a span whose ends were read in different threads, both on
    the span clock (`time.perf_counter_ns`), in the calling thread's
    name."""
    if _on or _torch_profiler._is_profiler_enabled:
        _records.append((name, get_ident(), start_ns, end_ns, None, None))


def start_trace():
    """A started torch.profiler profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def stop_trace(prof, log_dir: str | Path) -> Path:
    """Stop `prof` and write its trace; returns the file."""
    prof.stop()
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    path = Path(log_dir) / "trace.json"
    prof.export_chrome_trace(str(path))
    return path


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Record a torch.profiler trace of the block into
    `log_dir/trace.json` (`gpv_tpu.utils.profiling.trace`, which writes a
    jax.profiler trace there)."""
    prof = start_trace()
    try:
        yield prof
    finally:
        stop_trace(prof, log_dir)


class StepTimer:
    """Rolling per-step wall-clock stats for the train loop."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times: list[float] = []
        self._last = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
            if len(self.times) > self.window:
                self.times.pop(0)
        self._last = now

    @property
    def mean_s(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0

    def steps_per_sec(self) -> float:
        m = self.mean_s
        return 1.0 / m if m > 0 else 0.0
