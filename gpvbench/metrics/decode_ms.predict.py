"""Wall ms a batch in the greedy decode loop (`decode/greedy.py`
`greedy_decode` as the engine calls it), from the benchmark's span
around it."""
LAYER = "decode loop (decode/greedy.py, through engine.py)"
UNIT = "ms"
MOVES = "predict_images_per_s"


def read(trace):
    d = trace.spans.durations("decode")
    return 1e3 * sum(d) / len(d) if d else None
