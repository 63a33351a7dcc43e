"""rank_cap_ms: step 1 of the rank, the MaxMatches cap (a lexsort and its gathers;
CUDA events), the entry's span ``rank.cap``, summed over the batches,
per call."""

from benchmark.harness.spans import span_ms


def read(trace):
    return span_ms(trace, "rank.cap")
