"""Device ms a train step of the collective kernels on the profiled rank
(those `kernels/collective-*.json` name: NCCL's, DDP's gradient
all-reduce), over the steps of the profiled window; nothing where the
trace holds none (one card)."""
from gpvbench.trace import matches, patterns

LAYER = "data parallelism (parallel/train_step.py DDP, NCCL all-reduce)"
UNIT = "ms"
MOVES = "train_images_per_s"


def collective(name: str) -> bool:
    return matches(name, [f for fs in patterns("collective").values()
                          for f in fs])


def read(trace):
    p = trace.profile
    if p is None or not p.events or not p.counts.get("steps"):
        return None
    busy = sum(e.end - e.start for e in p.events if collective(e.name))
    if not busy:
        return None
    return 1e3 * busy / p.counts["steps"]
