"""95th percentile, over the requests submitted inside the profiled
window, of the ms from a request's submit to the start of the batch that
runs it: the program's record `serve.queue` (`serve.py` `GPVServer`)."""
import numpy as np

from gpvbench.spans import starting_in_window

LAYER = "server (serve.py GPVServer)"
UNIT = "ms"
MOVES = "request_p95_ms"


def read(trace):
    waits = [r.wall for r in starting_in_window(trace, "serve.queue")]
    return 1e3 * float(np.percentile(waits, 95)) if waits else None
