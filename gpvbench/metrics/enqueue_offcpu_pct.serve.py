"""Share of the server workers' runnable host time spent off a core (the
interpreter lock, the OS): 100 x (1 - thread CPU time / wall time) over
the program's spans that never wait on the card, `engine.tokenize`,
`engine.encode`, `decode.step` less its nested `decode.stop_wait`, and
`engine.detokenize`, inside the profiled window (the spans of threads
that read their CPU time: the server's workers)."""
from gpvbench.spans import cpu, in_window, wall

LAYER = "server (serve.py GPVServer)"
UNIT = "%"
MOVES = "request_p95_ms"
RUNNABLE = ("engine.tokenize", "engine.encode", "decode.step",
            "engine.detokenize")


def read(trace):
    recs = [r for r in in_window(trace) or [] if r.cpu is not None]
    if not recs:
        return None
    t = wall(recs, *RUNNABLE) - wall(recs, "decode.stop_wait")
    c = cpu(recs, *RUNNABLE) - cpu(recs, "decode.stop_wait")
    return 100.0 * (1.0 - c / t) if t > 0 else None
