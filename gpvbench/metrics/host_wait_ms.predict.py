"""Host ms a predict call spends blocked on the card: the program's spans
`decode.stop_wait` (the greedy loop's per-step `bool(stopped.all())`)
and `engine.fetch` (the answers' copies to the host), over the calls of
the profiled window."""
from gpvbench.spans import in_window, per, wall

LAYER = "engine host path (engine.py GPVEngine.predict)"
UNIT = "ms"
MOVES = "predict_images_per_s"


def read(trace):
    return per(in_window(trace), "engine.detokenize",
               lambda recs: wall(recs, "decode.stop_wait", "engine.fetch"))
