"""pairs_per_read: the candidate pairs that the probe hands the expand
(``timings["pairs"]``) per read handed to the entry (``timings["counts"]
["reads"]``), over the traced window's calls: the expand and verify's
attempts a read."""

from benchmark.harness.spans import ratio


def read(trace):
    return ratio(trace, lambda t: t["pairs"], lambda t: t["counts"]["reads"])
