"""h2d_ms: the read rows' copy to the device (CUDA events on the upload's side
stream), the entry's span ``upload.h2d``, summed over the batches, per
call."""

from benchmark.harness.spans import span_ms


def read(trace):
    return span_ms(trace, "upload.h2d")
