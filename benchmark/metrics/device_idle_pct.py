"""device_idle_pct: the share of a profiled call's host wall, call start
to return, in which no kernel, copy or set runs on the card (the union of
the profiler's device events), in %."""


def read(trace):
    p = trace["profile"]
    if p["window_s"] <= 0 or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
