"""End-to-end matching on one device (port of
``muscato_tpu/engine/pipeline.py``'s single-device dedup path).

Unique reads stream through the resident target index in batches; each
batch runs probe -> expand -> verify -> rank on the device
(``ops/fused.py``) and only the retained rows come back to the host.
Multi-batch runs re-apply the per-group MaxMatches cap and the dedup/rank
over the union on the host, as the JAX engine does.

The JAX package's switches select the same alternatives here, read when a
run starts: ``MUSCATO_PJOIN=0`` takes the sort-merge probe instead of the
sorted join (unset or ``1`` keeps the join, as ``TUNED.json`` sets it), and
``MUSCATO_PEXPAND_SUB=1`` runs the pair expansion on the sub-chunked B6
kernel instead of B2.  Both give the same MatchResult.

Not ported yet (each raises NotImplementedError naming it): the streaming
expand (NoDedup, more than 31 windows, or a pair total above
``_MAX_PAIR_CAP``), the search and direct probes, and gene-range sharding.
The JAX engine's kernel-disable net and its window-overflow ladders are
not ported at all: they exist for Mosaic's windows, and the GPU kernels
have none.
"""

from __future__ import annotations

import logging
import os
import time
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from ..config import Config
from ..io.reads import ReadSet
from ..io.targets import TargetSet

from ..ops import fused
from ..ops import packed as packed_ops
from ..ops import verify as vops
from .index import TargetIndex, build_target_index

logger = logging.getLogger("muscato.pipeline")


@dataclass
class MatchResult:
    """Final retained matches, one entry per (unique read x gene x start)."""

    read_row: np.ndarray  # int32, row into the ReadSet
    gene: np.ndarray  # int32, row into the TargetSet
    start: np.ndarray  # int32, read start within the gene (reported pos)
    nmiss: np.ndarray  # int32


def _round_up(n: int, to: int) -> int:
    return max(to, -(-n // to) * to)


# Pair-buffer floor for the dedup expand (sized per batch from the probe's
# pair total in quarter-power-of-two buckets), and the ceiling past which
# the JAX engine streams the expansion instead.
_PAIR_FLOOR = 1 << 18
_MAX_PAIR_CAP = 1 << 26
_SURV_CAP0 = 1 << 16


def _bucket_ceil(n: int) -> int:
    """Smallest p * 2^k >= n with p in {5,6,7,8}: quarter-pow2 capacity
    buckets (overshoot at most 25%)."""
    n = max(int(n), 8)
    k = max((n - 1).bit_length() - 3, 0)
    return ((n + (1 << k) - 1) >> k) << k


def _window_has_reads(rs: ReadSet, q1: int, width: int) -> bool:
    """The reference's per-window abort counts reads passing the *length*
    gate only (cmd/muscato_window_reads/main.go:108-112)."""
    return bool(np.any(rs.lengths >= q1 + width))


def _switch(name: str, default: bool) -> bool:
    """An engine switch as the JAX package reads it: on iff the variable is
    "1", the default when it is unset."""
    v = os.environ.get(name)
    return default if v is None else v == "1"


def run_matching(cfg: Config, rs: ReadSet, ts: TargetSet, *, device,
                 index: TargetIndex | None = None) -> MatchResult:
    if index is None:
        index = build_target_index(ts, cfg.WindowWidth, device)
    return run_matching_indexed(cfg, rs, index)


class _StageClock:
    """Per-stage times of the batch loop: CUDA events on a CUDA device (the
    device timeline), host perf_counter on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []  # (stage name, event or time) at each stage start

    def mark(self, name: str) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))
        else:
            self.marks.append((name, time.perf_counter()))

    def sums(self) -> dict:
        if self.cuda:
            torch.cuda.synchronize()
        out = {}
        for (name, a), (_n, b) in zip(self.marks, self.marks[1:]):
            if name == "end":
                continue
            dt = a.elapsed_time(b) / 1e3 if self.cuda else b - a
            out[name] = out.get(name, 0.0) + dt
        return out


def run_matching_indexed(cfg: Config, rs: ReadSet, index: TargetIndex,
                         probe: str | None = None,
                         timings: dict | None = None) -> MatchResult:
    """Match a ReadSet against a prebuilt index on the index's device.

    probe: None or 'sort' (the sorted-join probe, or the sort-merge probe
    under MUSCATO_PJOIN=0; their results are exact like the search
    probe's).  MUSCATO_PEXPAND_SUB=1 expands on B6.  timings, when given,
    receives per-stage seconds under 'stages' (probe, expand_verify, rank;
    CUDA-event device time on a GPU), the host seconds spent packing and
    uploading read batches ('read_prep_s') and fetching and unpacking the
    retained rows ('fetch_s'), 'pairs' (the candidate pair total) and
    'batches'."""
    if probe not in (None, "sort"):
        raise NotImplementedError(
            f"the {probe!r} probe is not ported to muscato_tpu_torch; the "
            "sorted-join probe gives the same results"
        )
    if len(cfg.Windows) > 31 or cfg.NoDedup:
        raise NotImplementedError(
            "the streaming expand (NoDedup or more than 31 windows) is not "
            "ported to muscato_tpu_torch yet"
        )
    probe_fn = (fused._probe_windows_pjoin_impl if _switch("MUSCATO_PJOIN", True)
                else fused._probe_windows_impl)
    subchunk = _switch("MUSCATO_PEXPAND_SUB", False)
    device = index.device
    width = cfg.WindowWidth
    # Trim the packed read matrix to the longest actual read.
    l_eff = int(max(int(rs.lengths.max(initial=0)), width))
    l_eff = min(l_eff, rs.codes.shape[1]) or rs.codes.shape[1]
    budget = torch.from_numpy(
        vops.mismatch_budget_table(cfg.PMatch, cfg.MaxReadLength)
    ).to(device)
    vchunk = cfg.MaxPairChunk or (1 << 20)
    q1s = tuple(int(q) for q in cfg.Windows)

    # The reference aborts when a window seeds no reads
    # (cmd/muscato_window_reads/main.go:143-151).
    for k, q1 in enumerate(q1s):
        if not _window_has_reads(rs, q1, width):
            raise SystemExit(f"Window {k} produced no valid reads, exiting")

    nreads = rs.codes.shape[0]
    batch = cfg.ReadBatch or (1 << 22)
    batch = min(batch, _round_up(nreads, 1024))
    nbatches = -(-nreads // batch)
    trows = index.trows(packed_ops.packed_width(l_eff))
    gblock, gsteps = index.gene_block()
    surv_cap = _SURV_CAP0
    # Single-batch retained rows come back 64-bit packed; the multi-batch
    # path re-caps across batches and needs the group columns.
    pack_bits = _fetch_pack_bits(index, batch, cfg) if nbatches == 1 else None
    clock = _StageClock(device) if timings is not None else None

    surv_rows = []
    total_pairs = 0
    read_prep_s = 0.0
    for b0 in range(0, nreads, batch):
        t_batch = time.perf_counter()
        b1 = min(b0 + batch, nreads)
        rpacked, lengths = _device_read_batch(rs, b0, b0 + batch, l_eff, device)
        read_prep_s += time.perf_counter() - t_batch
        if clock:
            clock.mark("probe")
        pr = probe_fn(
            rpacked, lengths, q1s, index.skeys, width=width,
            min_dinuc=cfg.MinDinuc,
        )
        total = int(pr.total)
        if total > 2**30:
            raise ValueError(
                f"candidate pair count {total} in one read batch exceeds the "
                "2**30 expansion limit; re-run with a smaller ReadBatch (or "
                "raise MinDinuc)"
            )
        if total > _MAX_PAIR_CAP:
            raise NotImplementedError(
                f"a batch with {total} candidate pairs needs the streaming "
                "expand, which is not ported to muscato_tpu_torch yet; "
                "re-run with a smaller ReadBatch"
            )
        if clock:
            clock.mark("expand_verify")
        pair_cap = max(_PAIR_FLOOR, _bucket_ceil(total))
        ver = fused.expand_verify_dedup(
            pr, q1s, rpacked, lengths, index.spos, index.gene_start, budget,
            width=width, max_read_length=cfg.MaxReadLength, pair_cap=pair_cap,
            vchunk=min(vchunk, pair_cap), smax=index.num_bases, trows=trows,
            gblock=gblock, gsteps=gsteps, subchunk=subchunk,
        )
        nsurv = int(ver.nsurv)
        # Survivor-capacity regrow: the sorted survivors are all on the
        # device, so growing the buffer re-runs nothing.
        while nsurv > surv_cap:
            surv_cap = max(surv_cap * 2, _bucket_ceil(nsurv))
        buf = fused.survivor_rows(
            ver, pr.keyf, pr.key2f, nreads=rpacked.shape[0], nwin=len(q1s),
            surv_cap=surv_cap,
        )
        if clock:
            clock.mark("rank")
        total_pairs += total
        count = 0
        if nsurv:
            rows_dev, count_d = fused.rank_survivors(
                buf, nsurv, cfg.MaxMatches, cfg.MMTol,
                match_mode=cfg.MatchMode, full_cols=nbatches > 1,
                pack_bits=pack_bits,
            )
            count = int(count_d)
            surv_rows.append((rows_dev[:count], b0))
        if clock:
            clock.mark("end")
        dt = time.perf_counter() - t_batch
        logger.info(
            "batch reads [%d,%d): %d pairs, %d survivors, %d retained, "
            "%.2fs (%.0f reads/s)",
            b0, b1, total, nsurv, count, dt, (b1 - b0) / max(dt, 1e-9),
        )

    t_fetch = time.perf_counter()
    fetched = []
    for rows_dev, b0 in surv_rows:
        rows = rows_dev.cpu().numpy()
        if pack_bits is not None:
            rows = _unpack_rows64(rows, pack_bits)
        rows[:, 0] += b0  # batch-local read row -> global row
        fetched.append(rows)
    if timings is not None:
        timings["stages"] = clock.sums()
        timings["read_prep_s"] = read_prep_s
        timings["fetch_s"] = time.perf_counter() - t_fetch
        timings["pairs"] = total_pairs
        timings["batches"] = nbatches
    logger.info(
        "windows %s: %d candidate pairs, %d retained",
        cfg.Windows, total_pairs, sum(len(x) for x in fetched),
    )

    if not fetched:
        z = np.zeros(0, dtype=np.int32)
        return MatchResult(z, z, z, z)
    rows = np.concatenate(fetched)
    if nbatches == 1:
        # The device already produced the final retained set in canonical
        # (read, gene, start) order.
        return MatchResult(
            rows[:, 0].copy(), rows[:, 1].copy(),
            rows[:, 2].copy(), rows[:, 3].copy(),
        )
    # Several batches: k-mer cap groups span batches, so re-apply the cap
    # over the union and re-rank (both idempotent on filtered rows).
    r, g, s, nx, grp, grp2, win = (rows[:, i] for i in range(fused.NCOL))
    r, g, s, nx = _apply_max_matches(cfg, r, g, s, nx, grp, grp2, win)
    return _dedup_and_rank(cfg, r, g, s, nx)


def _fetch_pack_bits(index: TargetIndex, batch: int, cfg: Config):
    """Static bit widths (rbits, gbits, sbits, xbits) for the 64-bit packed
    retained-row fetch, or None when the fields cannot fit."""
    gs = index.gene_start_np
    maxg = int(np.max(np.diff(gs))) if len(gs) > 1 else 1
    ngenes = len(gs) - 1
    bmax = int(vops.mismatch_budget_table(cfg.PMatch, cfg.MaxReadLength).max())
    rb = max(1, (batch - 1).bit_length())
    gb = max(1, (max(ngenes, 1) - 1).bit_length() or 1)
    sb = max(1, maxg.bit_length())
    xb = max(1, bmax.bit_length())
    bits = (rb, gb, sb, xb)
    return bits if sum(bits) <= 64 else None


def _unpack_rows64(rows: np.ndarray, pack_bits) -> np.ndarray:
    """(n, 2) int32 lo/hi words -> (n, 4) int32 (read, gene, start, nmiss)."""
    rb, gb, sb, xb = pack_bits
    u = rows[:, 0].astype(np.uint32).astype(np.uint64) | (
        rows[:, 1].astype(np.uint32).astype(np.uint64) << np.uint64(32)
    )
    out = np.empty((len(rows), 4), dtype=np.int32)
    for col, b in ((3, xb), (2, sb), (1, gb), (0, rb)):
        out[:, col] = (u & np.uint64((1 << b) - 1)).astype(np.int32)
        u >>= np.uint64(b)
    return out


def _device_read_batch(rs: ReadSet, b0: int, b1: int, l_eff: int, device):
    """Device tensors (rpacked int32 (n, nw), lengths int32 (n,)) for read
    rows [b0, b1), padded to the batch size with empty rows.  The uint8
    codes are uploaded and nibble-packed on the device: packing a 4M-read
    batch on the host took most of the flagship's wall time."""
    n = b1 - b0
    real = np.ascontiguousarray(rs.codes[b0:b1, :l_eff])
    real_n = real.shape[0]
    codes = torch.zeros((n, l_eff), dtype=torch.uint8, device=device)
    lengths = torch.zeros(n, dtype=torch.int32, device=device)
    with warnings.catch_warnings():
        # Host arrays from np.frombuffer are read-only; they are only read.
        warnings.simplefilter("ignore", UserWarning)
        codes[:real_n].copy_(torch.from_numpy(real))
        lengths[:real_n].copy_(torch.from_numpy(
            np.ascontiguousarray(rs.lengths[b0 : b0 + real_n], dtype=np.int32)
        ))
    return packed_ops.pack_rows(codes), lengths


def _apply_max_matches(cfg, r, g, s, nx, grp, grp2, win):
    """Per-(window, k-mer group) cap on emitted matches
    (cmd/muscato_confirm/main.go:236-242); 'first' mode keeps MaxMatches+1
    rows per group like the reference's append-then-check."""
    mm = cfg.MaxMatches
    if cfg.MatchMode == "first":
        order_cols = (r, s, g, grp2, grp, win)
    else:
        order_cols = (r, s, g, nx, grp2, grp, win)
    order = np.lexsort(order_cols)  # last key is primary: (window, group)-major
    w_s, grp_s, grp2_s = win[order], grp[order], grp2[order]
    newgrp = np.concatenate(
        [[True],
         (w_s[1:] != w_s[:-1]) | (grp_s[1:] != grp_s[:-1])
         | (grp2_s[1:] != grp2_s[:-1])]
    )
    grp_ix = np.cumsum(newgrp) - 1
    first_of_grp = np.flatnonzero(newgrp)
    rank = np.arange(len(grp_s)) - first_of_grp[grp_ix]
    cap = mm + 1 if cfg.MatchMode == "first" else mm
    kept = order[rank < cap]
    return r[kept], g[kept], s[kept], nx[kept]


def _dedup_and_rank(cfg, r, g, s, nx):
    """Exact dedup on (read, gene, start) then per-read best+MMTol filter
    (combine_filter + sort -u + combine_windows,
    reference cmd/muscato/main.go:422-505)."""
    order = np.lexsort((s, g, r))
    r, g, s, nx = r[order], g[order], s[order], nx[order]
    if len(r):
        first = np.concatenate(
            [[True], (r[1:] != r[:-1]) | (g[1:] != g[:-1]) | (s[1:] != s[:-1])]
        )
        r, g, s, nx = r[first], g[first], s[first], nx[first]

    if len(r):
        read_first = np.concatenate([[True], r[1:] != r[:-1]])
        seg = np.cumsum(read_first) - 1
        best = np.full(seg[-1] + 1, np.iinfo(np.int32).max, dtype=np.int64)
        np.minimum.at(best, seg, nx)
        keep = nx <= best[seg] + cfg.MMTol
        r, g, s, nx = r[keep], g[keep], s[keep], nx[keep]

    return MatchResult(r, g, s, nx)
