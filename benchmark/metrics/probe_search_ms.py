"""probe_search_ms: the search probe's search (B8's or B9's launch), the
entry's span ``probe.search`` (CUDA events, through
``probe_windows(span=)``), per call; None where the span is absent (the
sorted join and the sort-merge probe open none)."""

from benchmark.harness.spans import span_ms


def read(trace):
    return span_ms(trace, "probe.search")
