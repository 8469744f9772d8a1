"""Host ms a train step spends in the Hungarian matcher's solve, while the
card has nothing queued: the program's span `train.matcher.solve`
(`ops/matcher.py` `hungarian_match`: the native solve and the
assignment's upload), over the steps of the profiled window."""
from gpvbench.spans import in_window, per, wall

LAYER = "train step (parallel/train_step.py, losses/criterion.py, nn/layers.py)"
UNIT = "ms"
MOVES = "train_images_per_s"


def read(trace):
    return per(in_window(trace), "train.adamw",
               lambda recs: wall(recs, "train.matcher.solve"))
