"""Find a serving cell's knee once, by offering rates in turn to one warm
server (`drivers/serve.py` `sweep`); one JSON line a rate.

    python3 -m gpvbench.sweep --workload serve-open-r50 --rates 40,80,120 \
        --seconds 20 --seed 5 --out FILE

The knee is the highest rate whose p95 stays within the limit the cell
states and whose backlog does not grow; the cell then offers a fixed share
of it. Not run by the benchmark itself.
"""
from __future__ import annotations

import argparse
import json
import time

from gpvbench import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    ctx = run.make_ctx(run.manifest(), args.workload, args.seed,
                       args.seconds, False, "cuda", time.perf_counter())
    rows = ctx.driver().sweep(ctx, [float(r) for r in args.rates.split(",")],
                        args.seconds)
    with open(args.out, "a") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
