"""Host ms a predict call spends copying its inputs to the card: the
program's span `engine.upload` (`engine.py` `GPVEngine._greedy_shard`,
every host-to-device copy of the call), over the calls of the profiled
window (one `engine.detokenize` a call)."""
from gpvbench.spans import in_window, per, wall

LAYER = "engine host path (engine.py GPVEngine.predict)"
UNIT = "ms"
MOVES = "predict_images_per_s"


def read(trace):
    return per(in_window(trace), "engine.detokenize",
               lambda recs: wall(recs, "engine.upload"))
