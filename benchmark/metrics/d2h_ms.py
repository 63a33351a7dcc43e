"""d2h_ms: the retained rows' copy to the host (a synchronous ``.cpu()``; host
clock), the entry's span ``fetch.d2h``, summed over the batches, per
call."""

from benchmark.harness.spans import span_ms


def read(trace):
    return span_ms(trace, "fetch.d2h")
