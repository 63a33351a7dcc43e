"""read_pack_ms: the nibble pack of the uploaded reads (``packed.pack_rows``; CUDA
events), the entry's span ``read_pack``, summed over the batches, per
call."""

from benchmark.harness.spans import span_ms


def read(trace):
    return span_ms(trace, "read_pack")
