"""probe_compact_ms: the search probe's compaction in lo order
(``fused._compact_lo_order``'s sort), the entry's span ``probe.compact``
(CUDA events, through ``probe_windows(span=)``), per call; None where the
span is absent (the sorted join and the sort-merge probe open none)."""

from benchmark.harness.spans import span_ms


def read(trace):
    return span_ms(trace, "probe.compact")
