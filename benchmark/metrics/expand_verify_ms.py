"""expand_verify_ms: the expand and verify stage
(``fused.expand_verify_dedup``, ``packed.verify_diagonals_packed``: B2,
B3, B4, B7), the entry's ``timings["stages"]["expand_verify"]`` (CUDA
events), per call."""

from benchmark.harness.readers import stage_ms


def read(trace):
    return stage_ms(trace, "expand_verify")
