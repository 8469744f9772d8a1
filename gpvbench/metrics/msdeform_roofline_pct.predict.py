"""The deformable sampling kernel's share of its roofline in a predict
cell: the least time of the model's deformable attention sampling in the
profiled calls (`counts["bound_ms"]["msdeform"]`: each layer's value,
offsets, logits, reference points and output at the card's memory rate,
or its operations at the peak, from the configuration's shapes by its
family's `predict_work`) over the device time of the kernels that
`kernels/msdeform-*.json` name. The trace has to hold every launch the
program counted in the window, variant by variant
(`counts["launches"]["msdeform"]`, `trace.launch_gaps`), as for
`attn_roofline_pct.predict`. A model without deformable attention reads
nothing."""
from gpvbench.trace import launch_gaps, matches, variants

LAYER = "kernels (ops/ms_deform_attn.py, csrc/ms_deform_attn.cu)"
UNIT = "%"
MOVES = "predict_images_per_s"


def read(trace):
    p = trace.profile
    if p is None or not p.events:
        return None
    want_ms = p.counts.get("bound_ms", {}).get("msdeform")
    if not want_ms:
        return None
    gaps = launch_gaps(p.events, p.counts["launches"].get("msdeform", {}),
                       "msdeform")
    if gaps:
        raise RuntimeError("the trace does not hold the msdeform launches "
                           "the program counted: " + "; ".join(gaps))
    frags = [f for fs in variants("msdeform").values() for f in fs]
    device_ms = 1e3 * sum(e.end - e.start for e in p.events
                          if matches(e.name, frags))
    if not device_ms:
        return None
    return 100.0 * want_ms / device_ms
