"""Device ms a train step in which the profiled rank's card runs a
collective kernel (`kernels/collective-*.json`: NCCL's all-reduce) and
nothing else: the union of all its device intervals less the union of
the non-collective ones, inside the profiled window, over its steps.
What the backward does not hide of the gradient all-reduce; nothing
where the trace holds no collective (one card)."""
from gpvbench.trace import matches, patterns, union_seconds

LAYER = "data parallelism (parallel/train_step.py DDP, NCCL all-reduce)"
UNIT = "ms"
MOVES = "train_images_per_s"


def read(trace):
    p = trace.profile
    if p is None or not p.events or not p.counts.get("steps"):
        return None
    frags = [f for fs in patterns("collective").values() for f in fs]
    spans = [(max(e.start, p.t0), min(e.end, p.t1), matches(e.name, frags))
             for e in p.events if e.end > p.t0 and e.start < p.t1]
    if not any(c for _, _, c in spans):
        return None
    every = union_seconds([(a, b) for a, b, _ in spans])
    other = union_seconds([(a, b) for a, b, c in spans if not c])
    return 1e3 * (every - other) / p.counts["steps"]
