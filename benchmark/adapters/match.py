"""Entry adapter ``match``: the window drives
``muscato_tpu_torch.engine.pipeline.run_matching_indexed(cfg, rs, index)``
as ``muscato_torch`` does for each batch of a user's job: it takes a host
``ReadSet`` and returns a host ``MatchResult``, after the upload, the
probe, the expand and verify, the rank and the row fetch, against an
index resident on the card.

Set-up makes the genes and the read pool from the seed (``traffic.py``),
builds the index on the card (``build_target_index(...,
device_build=True)``) and runs WARMUP calls at the cell's shapes.  Each
call then takes ``reads_per_call`` consecutive rows of the pool from an
offset drawn from the seed, as a ReadSet of its own, so that the device
copy the engine caches on a ReadSet never serves a call.

``compare`` holds the MatchResult of the calls kept (the last call of the
window and a sample drawn from the seed) against the plain reference
(``harness/reference.py``), computed on the genes and reads that the
benchmark made, after the program's index is freed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import reference, traffic

WARMUP = 2
# Controls: the reference itself, with one guarantee of the configuration
# broken, put in the program's place.
CONTROLS = {"budget-1": dict(budget_delta=-1)}


def _config(cell):
    from muscato_tpu_torch.config import Config

    return Config(**cell.config["config"])


def setup(cell, seed: int, device) -> dict:
    """The state the calls share; its ``setup_parts`` give the seconds of
    each part of the set-up."""
    device = torch.device(device)
    parts, t = {}, time.perf_counter()

    def part(name):
        nonlocal t
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        parts[name], t = now - t, now

    from muscato_tpu_torch.engine.index import build_target_index
    from muscato_tpu_torch.io.targets import TargetSet

    cfg = _config(cell)
    part("port_import_s")
    read_length = int(cell.config["read_length"])
    genes, gene_start, pool = traffic.make_cell_data(
        cell.config["genes"], read_length, cell.traffic, seed, device)
    part("data_s")
    ts = TargetSet(tcat=genes.cpu().numpy(), gene_start=gene_start, names=[],
                   lengths=np.diff(gene_start))
    part("genes_to_host_s")
    index = build_target_index(ts, cfg.WindowWidth, device, device_build=True)
    part("index_s")
    per_call = int(cell.traffic["reads_per_call"])
    state = dict(cfg=cfg, device=device, genes=genes, gene_start=gene_start, pool=pool,
                 lengths=np.full(len(pool), read_length, np.int32),
                 counts=np.ones(len(pool), np.int64), index=index, per_call=per_call,
                 offsets=traffic.call_offsets(seed, len(pool), per_call), setup_parts=parts)
    warm = traffic.call_offsets(seed, len(pool), per_call, stream=2)
    for k in range(WARMUP):
        _run(state, next(warm))
        part(f"warm{k}_s")
    return state


def _run(state, offset: int, timings=None):
    from muscato_tpu_torch.engine import pipeline
    from muscato_tpu_torch.io.reads import ReadSet

    n = state["per_call"]
    rows = slice(offset, offset + n)
    rs = ReadSet(codes=state["pool"][rows], lengths=state["lengths"][rows],
                 counts=state["counts"][rows], num_total=n)
    return pipeline.run_matching_indexed(state["cfg"], rs, state["index"], timings=timings)


def call(state, timings=None) -> tuple:
    """One call of the entry on the next reads: (reads handed over, what
    the call returned, the call's offset into the pool)."""
    offset = next(state["offsets"])
    return state["per_call"], _run(state, offset, timings), offset


def release(state) -> None:
    """Free the program's state (its index on the card)."""
    state.pop("index", None)
    if state["device"].type == "cuda":
        torch.cuda.synchronize(state["device"])
        torch.cuda.empty_cache()


def _rows(mr) -> torch.Tensor:
    return torch.from_numpy(np.stack([mr.read_row, mr.gene, mr.start, mr.nmiss], 1)
                            .astype(np.int64))


def reads_differing(got: torch.Tensor, want: torch.Tensor) -> int:
    """Reads whose rows differ between ``got`` and ``want`` ((M, 4) int64
    rows, ``want``'s distinct): a row that the two hold a different
    number of times (missing, extra, altered or doubled)."""
    rows = torch.cat([got, want.to(got.device)])
    side = torch.cat([torch.zeros(len(got), dtype=torch.int64, device=got.device),
                      torch.ones(len(want), dtype=torch.int64, device=got.device)])
    order = torch.arange(len(rows), device=got.device)
    for col in (3, 2, 1, 0):
        order = order[torch.sort(rows[order, col], stable=True).indices]
    rows, side = rows[order], side[order]
    new = torch.ones(len(rows), dtype=torch.bool, device=got.device)
    new[1:] = (rows[1:] != rows[:-1]).any(1)
    group = torch.cumsum(new, 0) - 1
    ngroups = int(group[-1]) + 1 if len(rows) else 0
    count = torch.zeros((ngroups, 2), dtype=torch.int64, device=got.device)
    count.index_put_((group, side), torch.ones_like(side), accumulate=True)
    bad = count[:, 0] != count[:, 1]
    return int(torch.unique(rows[new][bad, 0]).numel())


def compare(state, kept, cell, control: str | None = None) -> tuple:
    """({name: (value, limit)} of the numbers compared, {name: count} of
    what was compared) over the calls ``kept`` ([(offset, MatchResult)]):
    the reads whose matches differ from the reference's, limit 0 (an exact
    comparison).  With ``control``, the control's matches stand in for
    the program's."""
    release(state)
    c = cell.config["config"]
    common = dict(windows=c["Windows"], width=c["WindowWidth"], pmatch=c["PMatch"],
                  min_dinuc=c["MinDinuc"], max_read_length=c["MaxReadLength"],
                  mmtol=c["MMTol"], max_matches=c["MaxMatches"], match_mode=c["MatchMode"])
    ref = reference.Reference(state["genes"], state["gene_start"], **common)
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
    return ({"reads_differing": (differing, 0)},
            {"calls_compared": len(kept), "reads_compared": n * len(kept), "rows_compared": rows})
