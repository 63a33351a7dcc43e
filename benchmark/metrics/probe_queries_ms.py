"""probe_queries_ms: the search probe's queries (B5's window queries and
``fused._sorted_queries``' sort), the entry's span ``probe.queries`` (CUDA
events, through ``probe_windows(span=)``), per call; None where the span is
absent (the sorted join and the sort-merge probe open none)."""

from benchmark.harness.spans import span_ms


def read(trace):
    return span_ms(trace, "probe.queries")
