"""rows_per_read: the rows that the batches' ranks retain
(``timings["counts"]["retained"]``, summed over the batches) per read
handed to the entry (``timings["counts"]["reads"]``), over the traced
window's calls: the rows that the fetch copies back and the host unpacks,
assembles and, over several batches, caps and ranks again, a read."""

from benchmark.harness.spans import ratio


def read(trace):
    return ratio(trace, lambda t: t["counts"]["retained"], lambda t: t["counts"]["reads"])
