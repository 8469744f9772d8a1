"""Share of the rows the server ran that were padding: a batch of n
requests runs at the smallest bucket >= n, filled by repeating the last
request (`serve.py` `GPVServer`, its `batch_occupancy` counter)."""
LAYER = "server (serve.py GPVServer)"
UNIT = "%"
MOVES = "request_p95_ms"


def read(trace):
    occ = trace.counts["server"].get("batch_occupancy")
    return None if occ is None else 100.0 * (1.0 - occ)
