"""The whole train step's share of the card's bf16 peak: model FLOPs of
the steps run in the profiled window (`flops_per_step`: the family's
`train_flops`; GPV-1's counts the forward, and twice the forward of
every part the backward runs through) over the window, against 989
TFLOP/s."""
from gpvbench.peaks import PEAK_FLOPS

LAYER = "whole train step"
UNIT = "%"
MOVES = "train_images_per_s"


def read(trace):
    p = trace.profile
    if p is None or not p.events:
        return None
    rate = p.counts["flops_per_step"] * p.counts["steps"] / p.window_s
    return 100.0 * rate / PEAK_FLOPS["bfloat16"]
