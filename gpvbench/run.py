"""Run one cell of the benchmark and print its result line.

    python3 -m gpvbench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout, on a machine with the cards the cell asks
for. Everything a cell is made of is found by name: the cell in
`BENCHMARK.json` (`workloads`), its configuration in the file its entry
names, its traffic in `gpvbench/traffic/<traffic>.json`, whose `driver`
names `gpvbench/drivers/<driver>.py`, and each per-layer metric in
`gpvbench/metrics/<metric name>.py`. A cell, a traffic mix, a driver or
a metric is added as new files and manifest entries.

What depends on the model's architecture is its configuration's family
(`family.py`), so a new architecture comes as new files too, in this
order:

1. the configuration, `gpvbench/configs/<name>.json`, with its `family`
   (F), its `reduced` list (every key changed from the source) and its
   `assumed` list;
2. `reference/F.py`: the plain forward pass and weights in fp32 torch
   with TF32 off, importing nothing of the program (`family.REFERENCE`
   names what it exposes), and `reference/F_train.py` where a cell
   trains;
3. `counts/F.py`: the model FLOPs and each kernel kind's work items of a
   call (`family.COUNTS`), importing nothing of the program;
4. `kernels/<kind>-<name>.json` for a new kernel: its name `fragments`,
   its counted `variants` and the program functions that count them
   (`counters`);
5. per-layer readers over the profile's `counts["bound_ms"]` and
   `counts["launches"]`, which the drivers fill from 3 and 4;
6. the traffic, if the cell needs a new one;
7. the cell's name appended to the `workloads` lists of the end-to-end
   (and per-layer) metrics it reports.

The traffic's driver module sets up (counted in `setup_s`, with its
parts on standard error), measures for `--seconds`, then the run checks
what the timed path produced against the plain reference (`judge.py`).
With `--trace 1` it also records host spans and one profiler window, and
the result carries the cell's per-layer metrics in place of its
end-to-end ones.

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` also
`breakdown`, and last `checks`, each number compared beside its limit
(also the last lines of standard error). Without a card, or with fewer
than the cell asks for, or with the JAX package or JAX loaded once the
window has closed, the run prints no result and exits non-zero.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Optional

from gpvbench import family

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "gpv_tpu")


def process_age() -> float:
    """Seconds since this process started (Linux /proc)."""
    ticks = os.sysconf("SC_CLK_TCK")
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19]) / ticks
    with open("/proc/uptime") as f:
        return float(f.read().split()[0]) - start


@dataclass
class Ctx:
    """What a driver is given: the cell, its seed and length, where it
    runs, its configuration and traffic, and where to put set-up times."""
    name: str
    seed: int
    seconds: float
    trace: bool
    device: str
    config: dict
    traffic: dict
    t_start: float                      # perf_counter at process start
    dtype: str = "bfloat16"
    control: bool = False               # also read the control (judge.py)
    root: Path = ROOT                   # the checkout
    setup: Dict[str, float] = field(default_factory=dict)
    log: Callable[[str], None] = lambda line: print(line, file=sys.stderr,
                                                   flush=True)

    @property
    def model(self) -> dict:
        return self.config["model"]

    def find(self, kind: str, name: str, ext: str) -> Path:
        """The file of one part of a cell, by its name."""
        return self.root / "gpvbench" / kind / f"{name}{ext}"

    def driver(self):
        name = self.traffic["driver"]
        return load_file(self.find("drivers", name, ".py"),
                         f"gpvbench_driver_{name}")

    def split(self, part: str, seconds: float) -> None:
        self.setup[part] = self.setup.get(part, 0.0) + seconds


def load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_entries(man: dict, cell: str) -> tuple:
    """(workload entry, end-to-end metric entries, per-layer entries) of
    `cell`: a metric with `workloads` belongs to the cells it lists, one
    without to every cell (per-layer: every cell that reports its
    `moves`)."""
    work = next((w for w in man["workloads"] if w["name"] == cell), None)
    if work is None:
        raise SystemExit(f"no workload {cell!r} in BENCHMARK.json")
    e2e = [m for m in man["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in man["per_layer"]
             if cell in m.get("workloads", [cell])
             and ("workloads" in m or m["moves"] in names)]
    return work, e2e, layer


def make_ctx(man: dict, cell: str, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, root: Path = ROOT) -> Ctx:
    work, _, _ = cell_entries(man, cell)
    conf = next(c for c in man["configs"] if c["name"] == work["config"])
    config = json.loads((root / conf["file"]).read_text())
    family.name(config)            # a configuration names its family
    traffic = json.loads((root / "gpvbench" / "traffic" /
                          f"{work['traffic']}.json").read_text())
    return Ctx(cell, int(seed), float(seconds), bool(trace), device, config,
               traffic, t_start, dtype=config.get("dtype", "bfloat16"),
               root=root)


def run_cell(man: dict, ctx: Ctx) -> dict:
    """Drive the cell and assemble its result line (a dict)."""
    _, e2e, layer = cell_entries(man, ctx.name)
    out = ctx.driver().run(ctx)
    found = sorted(m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN)
    if found:
        raise SystemExit("the run loaded " + ", ".join(found))
    limits = ctx.config["limits"]
    checks = {k: {"value": v, "limit": limits[k]}
              for k, v in out["readings"].items() if k in limits}
    correct = bool(checks) and all(c["value"] <= c["limit"]
                                   for c in checks.values())
    if ctx.trace:
        metrics = {}
        for m in layer:
            mod = load_file(ctx.find("metrics", m["name"], ".py"),
                            "gpvbench_metric_" + m["name"].replace(".", "_"))
            value = mod.read(out["trace"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        missing = [m["name"] for m in e2e if m["name"] not in out["metrics"]]
        if missing:
            raise SystemExit(f"{ctx.traffic['driver']} reported no {missing}")
        metrics = {m["name"]: {"value": out["metrics"][m["name"]],
                               "unit": m["unit"]} for m in e2e}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": out["device"]}
    if ctx.trace and out.get("breakdown"):
        result["breakdown"] = out["breakdown"]
    result["checks"] = checks
    return result


def power_limit() -> Optional[str]:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def main(argv=None) -> int:
    t_start = time.perf_counter() - process_age()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(CACHE / sub)
    man = manifest()
    work, _, _ = cell_entries(man, args.workload)
    t = time.perf_counter()
    import torch
    import gpv_tpu_torch  # noqa: F401  (the system under test)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(work["chips"]):
        print(f"gpvbench: {args.workload} needs {work['chips']} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    ctx = make_ctx(man, args.workload, args.seed, args.seconds,
                   bool(args.trace), "cuda", t_start)
    ctx.split("imports", time.perf_counter() - t)
    ctx.log(f"gpvbench: card {power_limit()}")
    result = run_cell(man, ctx)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
