"""Device ms a train step of the kernels of no kind that `kernels/*.json`
defines (attention, convolution, matrix product, copy, and any kind a
later file adds): the eager elementwise, normalisation, softmax, dropout,
loss and optimizer work of `parallel/train_step.py`,
`losses/criterion.py` and `nn/layers.py`."""
from gpvbench.trace import group_of, group_table

LAYER = "train step (parallel/train_step.py, losses/criterion.py, nn/layers.py)"
UNIT = "ms"
MOVES = "train_images_per_s"


def read(trace):
    p = trace.profile
    if p is None or not p.events:
        return None
    table = group_table()
    busy = sum(e.end - e.start for e in p.events
               if group_of(e.name, table) == "elementwise")
    return 1e3 * busy / p.counts["steps"]
