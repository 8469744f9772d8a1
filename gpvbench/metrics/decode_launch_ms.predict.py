"""Host ms a predict call spends issuing the greedy loop's work: the
program's spans `decode.step` (`decode/greedy.py` `greedy_decode`, one
iteration) less the `decode.stop_wait` nested in each (the host blocked
on the card), over the calls of the profiled window."""
from gpvbench.spans import in_window, per, wall

LAYER = "decode loop (decode/greedy.py, through engine.py)"
UNIT = "ms"
MOVES = "predict_images_per_s"


def read(trace):
    return per(in_window(trace), "engine.detokenize",
               lambda recs: wall(recs, "decode.step")
               - wall(recs, "decode.stop_wait"))
