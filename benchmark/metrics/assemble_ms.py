"""assemble_ms: the concatenation of the fetched rows and the MatchResult's columns
(host; range ``muscato.assemble``), the entry's span ``assemble``, per
call."""

from benchmark.harness.spans import span_ms


def read(trace):
    return span_ms(trace, "assemble")
