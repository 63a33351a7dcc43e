"""Helpers of the readers of the entry's own spans and counters: the
``timings["spans"]`` ({name: seconds} summed over a call's batches; host
perf_counter or CUDA events, as ``engine/pipeline.py`` ``_StageClock``
keeps them) and ``timings["counts"]`` (the call's reads, survivors and
retained rows) of each call of the traced window.  A program without them
(no such key in any call) gives None, and the metric is left out."""

from __future__ import annotations

from benchmark.harness.readers import per_call_ms


def span_ms(trace: dict, *names: str):
    """The sum of the spans ``names`` per call, in ms; a call that has
    spans but none of these counts 0; None where no call has any of
    them."""
    def get(t):
        found = [t["spans"][n] for n in names if n in t.get("spans", {})]
        return sum(found) if found else None
    return per_call_ms(trace, get)


def ratio(trace: dict, num, den):
    """Σ ``num(timings)`` over Σ ``den(timings)`` over the window's calls
    whose timings hold ``counts``; None where none does, or where the
    denominator's sum is 0."""
    ts = [c["timings"] for c in trace["calls"] if c["timings"] and "counts" in c["timings"]]
    total = sum(den(t) for t in ts)
    return sum(num(t) for t in ts) / total if ts and total else None
