"""unpack_ms: the unpack of the retained rows' 64-bit words and their read-row
offset (host; range ``muscato.fetch.unpack``), the entry's span
``fetch.unpack``, per call; a call of several batches fetches its rows
unpacked and has none."""

from benchmark.harness.spans import span_ms


def read(trace):
    return span_ms(trace, "fetch.unpack")
