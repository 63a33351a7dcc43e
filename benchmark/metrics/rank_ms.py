"""rank_ms: the rank stage (``fused.rank_survivors``), the entry's
``timings["stages"]["rank"]`` (CUDA events), per call; a call with no
survivors runs no rank and counts 0."""

from benchmark.harness.readers import stage_ms


def read(trace):
    return stage_ms(trace, "rank")
