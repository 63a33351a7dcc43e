"""call_p90_ms: the 90th percentile of the entry's call walls (host
clock, call to return) in the traced window, as Python's
``statistics.quantiles(walls, n=10)`` gives it."""

import statistics


def read(trace):
    walls = [c["wall_s"] for c in trace["calls"]]
    if len(walls) < 2:
        return None
    return 1e3 * statistics.quantiles(walls, n=10)[8]
