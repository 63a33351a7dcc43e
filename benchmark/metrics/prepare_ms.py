"""prepare_ms: the checks before the batch loop (the read width, each window's reads, the
probe's choice, the fetch's bit widths; host, under the profiler range
``muscato.prepare``) and the stage set-up (the search aux, the budget
table's upload), the entry's span ``prepare``, per call."""

from benchmark.harness.spans import span_ms


def read(trace):
    return span_ms(trace, "prepare")
