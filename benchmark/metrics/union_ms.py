"""union_ms: the host's cap and rank over the union of a call's batches
(``_apply_max_matches``, ``_dedup_and_rank``; ranges
``muscato.union.cap`` and ``muscato.union.rank``), the sum of the
entry's spans ``union.cap`` and ``union.rank``, per call; only a call of
several batches has them."""

from benchmark.harness.spans import span_ms


def read(trace):
    return span_ms(trace, "union.cap", "union.rank")
