"""upload_ms: the host's staging and upload of a call's read batch
(``_device_read_batch``, ``_PinnedUploads``), the entry's
``timings["read_prep_s"]``, per call of the traced window."""

from benchmark.harness.readers import per_call_ms


def read(trace):
    return per_call_ms(trace, lambda t: t.get("read_prep_s"))
