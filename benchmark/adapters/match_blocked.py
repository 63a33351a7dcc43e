"""Entry adapter ``match_blocked``: the ``match`` adapter (the same set-up,
calls, release and controls) whose check builds the plain reference's
window index in blocks of target positions
(``harness/reference_blocked.py``), for a gene set whose whole index the
reference could not hold on the card (1.5e9 bases).

``compare`` is ``match.compare`` with ``BlockedReference`` in the place of
``Reference``; the numbers it counts add the reference's peak device
memory, with what the run still holds (its genes and reads) counted in
(``reference_peak_bytes``, 0 on the CPU).
"""

from __future__ import annotations

import torch

from benchmark.adapters.match import (CONTROLS, _rows, call, reads_differing,  # noqa: F401
                                      release, setup)
from benchmark.harness import reference_blocked


def compare(state, kept, cell, control: str | None = None) -> tuple:
    """``match.compare`` against the blocked reference."""
    release(state)
    cuda = state["device"].type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(state["device"])
    c = cell.config["config"]
    ref = reference_blocked.BlockedReference(
        state["genes"], state["gene_start"], windows=c["Windows"], width=c["WindowWidth"],
        pmatch=c["PMatch"], min_dinuc=c["MinDinuc"], max_read_length=c["MaxReadLength"],
        mmtol=c["MMTol"], max_matches=c["MaxMatches"], match_mode=c["MatchMode"])
    n = state["per_call"]
    differing = rows = 0
    for offset, mr in kept:
        codes = torch.from_numpy(state["pool"][offset:offset + n])
        lengths = torch.from_numpy(state["lengths"][offset:offset + n])
        want = ref.match(codes, lengths)
        got = (ref.match(codes, lengths, **CONTROLS[control]) if control
               else _rows(mr).to(want.device))
        differing += reads_differing(got, want)
        rows += len(want)
    peak = torch.cuda.max_memory_allocated(state["device"]) if cuda else 0
    return ({"reads_differing": (differing, 0)},
            {"calls_compared": len(kept), "reads_compared": n * len(kept), "rows_compared": rows,
             "reference_peak_bytes": int(peak)})
