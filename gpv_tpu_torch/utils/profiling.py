"""Step timing and tracing for the train loop (counterpart of
`gpv_tpu/utils/profiling.py`): `StepTimer` keeps rolling per-step wall
times; `start_trace`/`stop_trace` record a torch.profiler trace, CPU and,
on the card, CUDA activity, to `log_dir/trace.json` (Chrome trace
format): the trainer's `training.profile_step`; `trace(log_dir)` wraps
the two around a block."""
from __future__ import annotations

import contextlib
import time
from pathlib import Path


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
