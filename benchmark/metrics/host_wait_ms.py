"""host_wait_ms: the host blocked on the device: a pinned buffer's previous copy
(``wait.upload``), the pair total (``wait.total``), the survivor count
(``wait.survivors``) and the retained count (``wait.count``), the sum of
the entry's four ``wait.*`` spans (host clock), per call."""

from benchmark.harness.spans import span_ms


def read(trace):
    return span_ms(trace, "wait.upload", "wait.total", "wait.survivors", "wait.count")
