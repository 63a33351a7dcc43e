"""assembly_ms: what a call spends outside its batch loop and its row
fetch: the MatchResult's columns, and the checks before the loop.  The
call's wall (host clock) less the entry's ``timings["device_s"]`` and
``timings["fetch_s"]``, per call."""


def read(trace):
    vals = [c["wall_s"] - c["timings"]["device_s"] - c["timings"]["fetch_s"]
            for c in trace["calls"]
            if c["timings"] and "device_s" in c["timings"] and "fetch_s" in c["timings"]]
    return 1e3 * sum(vals) / len(vals) if vals else None
