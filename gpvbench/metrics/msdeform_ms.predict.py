"""Device ms a predict call of the deformable sampling kernels (those
`kernels/msdeform-*.json` name), over the calls of the profiled window;
nothing where the trace holds none."""
from gpvbench.trace import matches, variants

LAYER = "kernels (ops/ms_deform_attn.py, csrc/ms_deform_attn.cu)"
UNIT = "ms"
MOVES = "predict_images_per_s"


def read(trace):
    p = trace.profile
    if p is None or not p.events or not p.counts.get("calls"):
        return None
    frags = [f for fs in variants("msdeform").values() for f in fs]
    busy = sum(e.end - e.start for e in p.events if matches(e.name, frags))
    if not busy:
        return None
    return 1e3 * busy / p.counts["calls"]
