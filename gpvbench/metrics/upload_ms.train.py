"""Host ms a train step spends copying its batch to the card: the
program's span `train.upload` (`parallel/train_step.py`,
`batch_to_device`), over the steps of the profiled window (one
`train.adamw` a step)."""
from gpvbench.spans import in_window, per, wall

LAYER = "train step (parallel/train_step.py, losses/criterion.py, nn/layers.py)"
UNIT = "ms"
MOVES = "train_images_per_s"


def read(trace):
    return per(in_window(trace), "train.adamw",
               lambda recs: wall(recs, "train.upload"))
