"""Helpers that the per-layer metric readers (``metrics/*.py``) share.

A reader takes the traced run's record: ``calls``, one dict a call of the
window (``wall_s``, ``reads``, the entry's ``timings``, ``peak_bytes``),
``profile``, the reduced profile of a call (``profiling.profiled_call``),
and ``kernel_profile``, that of a call whose port-kernel launches were
recorded.  It returns a number, or None where it
finds nothing to read.
"""

from __future__ import annotations


def per_call_ms(trace: dict, get):
    """The sum over the window's calls of ``get(timings)`` (seconds; None
    where the call has none) over the number of calls, in ms; None where
    no call has one."""
    vals = [get(c["timings"]) for c in trace["calls"] if c["timings"] is not None]
    if not vals or all(v is None for v in vals):
        return None
    return 1e3 * sum(v or 0.0 for v in vals) / len(vals)


def stage_ms(trace: dict, stage: str):
    """A stage span of the entry's ``timings["stages"]``, per call."""
    return per_call_ms(trace, lambda t: t.get("stages", {}).get(stage) if "stages" in t else None)
