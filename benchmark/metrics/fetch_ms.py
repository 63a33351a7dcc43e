"""fetch_ms: the row fetch after the batch loop (the retained rows'
device-to-host copy and their unpack), the entry's
``timings["fetch_s"]``, per call."""

from benchmark.harness.readers import per_call_ms


def read(trace):
    return per_call_ms(trace, lambda t: t.get("fetch_s"))
