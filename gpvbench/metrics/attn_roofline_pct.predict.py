"""The fused attention kernels' share of their roofline in a predict
cell: the least time of the model's attention in the profiled calls
(`counts["bound_ms"]["attention"]`: bytes or operations of each attention
product at the card's peak, from the configuration's shapes by its
family's `predict_work`) over the device time of the kernels that
`kernels/attention-*.json` name. The trace has to hold every launch the
program counted in the window, kernel variant by variant
(`counts["launches"]["attention"]`, `trace.launch_gaps`);
`drivers/predict.py` profiles another window when one lost records, and
a trace that still differs fails the run: the share is never read from
part of the work."""
from gpvbench.trace import launch_gaps, matches, variants

LAYER = "kernels (ops/attention.py, csrc/attention_tile.cu, attention_decode.cu)"
UNIT = "%"
MOVES = "predict_images_per_s"


def read(trace):
    p = trace.profile
    if p is None or not p.events:
        return None
    gaps = launch_gaps(p.events, p.counts["launches"]["attention"],
                       "attention")
    if gaps:
        raise RuntimeError("the trace does not hold the attention launches "
                           "the program counted: " + "; ".join(gaps))
    want_ms = p.counts["bound_ms"]["attention"]
    frags = [f for fs in variants("attention").values() for f in fs]
    device_ms = 1e3 * sum(e.end - e.start for e in p.events
                          if matches(e.name, frags))
    if not device_ms:
        return None
    return 100.0 * want_ms / device_ms
