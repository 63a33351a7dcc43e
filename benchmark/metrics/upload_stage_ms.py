"""upload_stage_ms: the copy of a call's read rows into the pinned buffer, its zero fill and
any pinned allocation (host; range ``muscato.upload.stage``), the entry's
span ``upload.stage``, summed over the batches, per call."""

from benchmark.harness.spans import span_ms


def read(trace):
    return span_ms(trace, "upload.stage")
