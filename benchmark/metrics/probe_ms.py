"""probe_ms: the probe stage (``fused.probe_windows``: B5, B1), the
entry's ``timings["stages"]["probe"]`` (CUDA events), per call."""

from benchmark.harness.readers import stage_ms


def read(trace):
    return stage_ms(trace, "probe")
