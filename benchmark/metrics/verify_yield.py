"""verify_yield: the verify's survivors (``timings["counts"]
["survivors"]``, summed over the batches) over the candidate pairs
(``timings["pairs"]``), over the traced window's calls, in %: the share of
the expand and verify's attempts that pass."""

from benchmark.harness.spans import ratio


def read(trace):
    r = ratio(trace, lambda t: t["counts"]["survivors"], lambda t: t["pairs"])
    return None if r is None else 100.0 * r
