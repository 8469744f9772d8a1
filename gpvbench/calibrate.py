"""Read a cell's correctness numbers over many seeds in one process: the
program's (which set each limit's lower reading) and the control's (the
reference in float8, which sets the upper one), as `judge.py` takes them.

    python3 -m gpvbench.calibrate --workload NAME --seeds 11,12,13 \
        --control 11,12,13 --seconds 3 --out FILE

Each seed is a whole run of the cell's driver with a short window at the
cell's own load; the readings go to FILE as one JSON line a seed. Not run
by the benchmark itself.
"""
from __future__ import annotations

import argparse
import json
import time

from gpvbench import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    man = run.manifest()
    control = {int(s) for s in args.control.split(",") if s}
    with open(args.out, "a") as f:
        for seed in (int(s) for s in args.seeds.split(",")):
            t = time.perf_counter()
            ctx = run.make_ctx(man, args.workload, seed, args.seconds, False,
                               "cuda", t)
            ctx.control = seed in control
            out = ctx.driver().run(ctx)
            line = {"workload": args.workload, "seed": seed,
                    "readings": out["readings"], "metrics": out["metrics"],
                    "seconds": time.perf_counter() - t}
            f.write(json.dumps(line) + "\n")
            f.flush()
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
