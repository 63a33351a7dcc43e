"""rank_dedup_ms: step 2 of the rank, the exact dedup on (read, gene, start) (a lexsort
and its gathers; CUDA events), the entry's span ``rank.dedup``, summed
over the batches, per call."""

from benchmark.harness.spans import span_ms


def read(trace):
    return span_ms(trace, "rank.dedup")
