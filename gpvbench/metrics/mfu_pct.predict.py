"""The whole predict call's share of the card's bf16 peak: model FLOPs of
the calls completed in the profiled window (`flops_per_call`: the
family's `predict_flops`, from the configuration's shapes) over the
window, against 989 TFLOP/s."""
from gpvbench.peaks import PEAK_FLOPS

LAYER = "whole predict call"
UNIT = "%"
MOVES = "predict_images_per_s"


def read(trace):
    p = trace.profile
    if p is None or not p.events:
        return None
    rate = p.counts["flops_per_call"] * p.counts["calls"] / p.window_s
    return 100.0 * rate / PEAK_FLOPS["bfloat16"]
