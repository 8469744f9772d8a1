"""Share of the profiled window of a train cell in which the card ran no
kernel and no copy: 1 - (union of device intervals) / window."""
LAYER = "device"
UNIT = "%"
MOVES = "train_images_per_s"


def read(trace):
    p = trace.profile
    if p is None or not p.events:
        return None
    return 100.0 * (1.0 - p.busy_s() / p.window_s)
