"""The program's own spans in a traced run, and the idle breakdown they name.

The program records its stages as spans (`gpv_tpu_torch.utils.profiling`:
`engine.*`, `decode.*`, `train.*`, `serve.*`) while a torch.profiler
records in its process, so a traced run's profiler window leaves them in
the program's buffer, on the host's perf_counter clock, the clock the
device events are put on (`trace.read_profile`). `in_window` takes them
out once (kept on the `TraceData` for every later reader) and gives the
ones inside the profiled window; a program without spans (an older
commit) gives None, and each reader then reads nothing.

`breakdown` names each idle gap of the device by the innermost span of
either kind around its middle, the program's or the benchmark's own.

    python3 -m gpvbench.spans --workload NAME --seed N --seconds S
        [--trace 0|1] [--spans 0|1]

runs one cell as `gpvbench.run` does and prints its result line, with
`--trace 1` also `program_breakdown` and `program_spans` ({name: [count,
total ms]} inside the profiled window); `--spans 1` records spans over
the whole run, traced or not (what they cost, and `program_spans_after`:
the spans after the profiled window, where no profiler runs).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Iterable, List, NamedTuple, Optional

from gpvbench import run
from gpvbench.trace import Spans, breakdown as bench_breakdown

NS = 1e-9


class Rec(NamedTuple):
    """A program span in seconds: `cpu` is the thread CPU time spent
    inside it (None for a span handed between threads)."""
    name: str
    thread: int
    start: float
    end: float
    cpu: Optional[float]

    @property
    def wall(self) -> float:
        return self.end - self.start


def program(trace) -> Optional[List[Rec]]:
    """Every program span the run recorded, or None when the program has
    none to give."""
    recs = getattr(trace, "program", None)
    if not recs:
        try:
            from gpv_tpu_torch.utils.profiling import drain
        except ImportError:
            return None
        recs = drain()
        trace.program = recs
    return seconds(recs)


def seconds(recs) -> List[Rec]:
    """The program's records (`utils.profiling.SpanRecord`, ns) as `Rec`."""
    return [Rec(r.name, r.thread, r.start_ns * NS, r.end_ns * NS,
                None if r.cpu_start_ns is None
                else (r.cpu_end_ns - r.cpu_start_ns) * NS) for r in recs]


def totals(recs: Iterable[Rec]) -> Dict[str, list]:
    """{span name: [count, total ms]}."""
    out: Dict[str, list] = {}
    for r in recs:
        t = out.setdefault(r.name, [0, 0.0])
        t[0] += 1
        t[1] += 1e3 * r.wall
    return out


def in_window(trace) -> Optional[List[Rec]]:
    """The program spans inside the profiled window; None without a
    window or without any."""
    p = trace.profile
    recs = program(trace)
    if p is None or recs is None:
        return None
    out = [r for r in recs if p.t0 <= r.start and r.end <= p.t1]
    return out or None


def starting_in_window(trace, name: str) -> List[Rec]:
    """The spans `name` that start inside the profiled window (a
    request's queue wait may end after it)."""
    p, recs = trace.profile, program(trace)
    if p is None or recs is None:
        return []
    return [r for r in recs if r.name == name and p.t0 <= r.start < p.t1]


def count(recs: Iterable[Rec], name: str) -> int:
    return sum(1 for r in recs if r.name == name)


def wall(recs: Iterable[Rec], *names: str) -> float:
    """Seconds inside the spans `names`, summed."""
    return sum(r.wall for r in recs if r.name in names)


def cpu(recs: Iterable[Rec], *names: str) -> float:
    """Thread CPU seconds inside the spans `names`, summed."""
    return sum(r.cpu for r in recs if r.name in names)


def per(recs: Optional[List[Rec]], unit: str, seconds) -> Optional[float]:
    """ms a `unit` span (one a call or a step): `seconds(recs)` over the
    window's `unit` spans; None without any."""
    if not recs or not count(recs, unit):
        return None
    return 1e3 * seconds(recs) / count(recs, unit)


def breakdown(events, spans: Spans, recs: Optional[List[Rec]], t0: float,
              t1: float, top: int = 10) -> dict:
    """`trace.breakdown` over the benchmark's spans and the program's
    together: each idle gap named by the innermost span of either kind."""
    both = Spans()
    both.records = list(spans.records) + [(r.name, r.start, r.end)
                                          for r in recs or []]
    return bench_breakdown(events, both, t0, t1, top)


def main(argv=None) -> int:
    t_start = time.perf_counter() - run.process_age()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(run.CACHE / sub)
    man = run.manifest()
    import torch
    from gpv_tpu_torch.utils import profiling
    if not torch.cuda.is_available():
        print("gpvbench.spans: needs a CUDA card", file=sys.stderr)
        return 2
    ctx = run.make_ctx(man, args.workload, args.seed, args.seconds,
                       bool(args.trace), "cuda", t_start)
    ctx.log(f"gpvbench: card {run.power_limit()}")
    kept: Dict[str, object] = {}
    driver = ctx.driver()

    class Keeping:
        """The cell's driver, keeping what it returns."""
        @staticmethod
        def run(c):
            kept.update(driver.run(c))
            return kept

    ctx.driver = lambda: Keeping
    if args.spans:
        profiling.enable()
    result = run.run_cell(man, ctx)
    trace = kept.get("trace")
    if trace is not None and trace.profile is not None:
        p, recs = trace.profile, program(trace)
        result["program_breakdown"] = breakdown(p.events, trace.spans,
                                                recs, p.t0, p.t1)
        result["program_spans"] = totals(in_window(trace) or [])
        result["program_spans_after"] = totals(
            r for r in recs or [] if r.start > p.t1)
    elif args.spans:
        result["program_spans"] = totals(seconds(profiling.drain()))
    if args.spans:
        profiling.disable()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
