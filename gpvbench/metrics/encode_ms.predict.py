"""Wall ms a batch in `GPV.encode` (ResNet, DETR, BERT, co-attention, the
relevance head), from the benchmark's span around it, which ends once
the device has finished the encode."""
LAYER = "model encode (models/gpv.py GPV.encode)"
UNIT = "ms"
MOVES = "predict_images_per_s"


def read(trace):
    d = trace.spans.durations("encode")
    return 1e3 * sum(d) / len(d) if d else None
