"""End-to-end matching on one device (port of
``muscato_tpu/engine/pipeline.py``'s single-device engine).

Unique reads stream through the resident target index in batches; each
batch runs probe -> expand -> verify -> rank on the device
(``ops/fused.py``) and only the retained rows come back to the host.
Multi-batch runs re-apply the per-group MaxMatches cap and the dedup/rank
over the union of the batches' rows, as the JAX engine does on the host,
with the batches' own rank on the device.  A batch takes the
diagonal-dedup expand, or, for NoDedup, more than 31 windows or a pair
total above ``_MAX_PAIR_CAP``, the streaming expand, as in the JAX engine.
Targets above 2**31-1 bases run as sequential gene-range shards
(``run_matching_gene_sharded``).

The probe is chosen as in the JAX engine: the search probe over the
index's SearchAux (a direct bucket fetch, or a bucketed binary search for
skewed keys) when the index holds more than 64 keys per query of a batch,
else the sorted join.  While the loop waits on batch N's pair total, batch
N+1's reads are already uploading (pinned host memory, a side stream) and
its probe is queued.

The JAX package's switches select the same alternatives here, read when a
run starts: ``MUSCATO_PJOIN=0`` takes the sort-merge probe instead of the
sorted join (unset or ``1`` keeps the join, as ``TUNED.json`` sets it),
``MUSCATO_PEXPAND_SUB=1`` runs the pair expansion on the sub-chunked B6
kernel instead of B2, and ``MUSCATO_PREFETCH_PROBE=0`` queues each batch's
probe in its own turn (its upload still goes ahead).  All give the same
MatchResult.  ``MUSCATO_STAGE_TIMES=1`` logs each batch's stage times and
their sums, in the JAX engine's words.  The JAX engine's kernel-disable
net and its window-overflow ladders are not ported: they exist for
Mosaic's windows, and the GPU kernels have none.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..config import Config
from ..io.reads import ReadSet
from ..io.targets import TargetSet

from ..ops import expand as expand_ops
from ..ops import fused
from ..ops import gather as gather_ops
from ..ops import join as join_ops
from ..ops import packed as packed_ops
from ..ops import search as search_ops
from ..ops import verify as vops
from ..ops import window_queries as wq_ops
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
# pair total in quarter-power-of-two buckets), the ceiling past which a
# batch streams the expansion instead, and the first survivor capacity.
_PAIR_FLOOR = 1 << 18
_MAX_PAIR_CAP = 1 << 26
_SURV_CAP0 = 1 << 16

# Process-wide survivor-capacity hint: a regrown capacity (dedup or
# streaming) persists across batches and runs, so that a later run starts
# at the capacity an earlier one needed and re-runs no streaming stage.
_CAP_HINT = [_SURV_CAP0]


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


# The JAX package's engine switches, each read when a run starts, with its
# default: on iff the variable is "1", the default when it is unset.
SWITCHES = {"MUSCATO_PJOIN": True, "MUSCATO_PEXPAND_SUB": False,
            "MUSCATO_PREFETCH_PROBE": True}


# The kernel wrappers, each with its launch count (``launches``), whose
# launches a run under MUSCATO_STAGE_TIMES=1 logs.
KERNELS = {"window_queries": wq_ops.window_queries, "sorted_join": join_ops.sorted_join,
           "expand_owners": expand_ops.expand_owners,
           "expand_owners_sub": expand_ops.expand_owners_sub,
           "monotone_gather": gather_ops.monotone_gather,
           "monotone_gather_rows": gather_ops.monotone_gather_rows,
           "verify_diagonals_swar": packed_ops.verify_diagonals_swar,
           "verify_pairs": packed_ops.verify_pairs_packed,
           "direct_probe": search_ops.direct_probe, "binary_probe": search_ops.binary_probe}


def switches() -> dict:
    """Each engine switch as a run starting now reads it."""
    return {k: d if os.environ.get(k) is None else os.environ[k] == "1"
            for k, d in SWITCHES.items()}


def run_matching(cfg: Config, rs: ReadSet, ts: TargetSet, *, device,
                 index: TargetIndex | None = None) -> MatchResult:
    if index is None:
        if int(ts.gene_start[-1]) > np.iinfo(np.int32).max:
            # Past the int32 position limit the targets run as sequential
            # gene-range shards on the one device.
            nsh = int(-(-int(ts.gene_start[-1]) // (3 << 29)))
            return run_matching_gene_sharded(cfg, rs, ts, nsh, device=device)
        index = build_target_index(ts, cfg.WindowWidth, device)
    return run_matching_indexed(cfg, rs, index)


def gene_range(ts: TargetSet, lo: int, hi: int) -> TargetSet:
    """Genes [lo, hi) of ``ts`` as a TargetSet of their own (gene ids and
    positions start at 0)."""
    start = int(ts.gene_start[lo])
    end = int(ts.gene_start[hi])
    return TargetSet(
        tcat=np.asarray(ts.tcat[start:end]),
        gene_start=np.asarray(ts.gene_start[lo : hi + 1]) - start,
        names=list(ts.names[lo:hi]),
        lengths=np.asarray(ts.lengths[lo:hi]),
    )


def run_matching_gene_sharded(cfg: Config, rs: ReadSet, ts: TargetSet,
                              nshards: int, *, device,
                              timings: dict | None = None) -> MatchResult:
    """Sequential gene-range sharding on one device: build and probe one
    contiguous gene-range index at a time, then run the cap, dedup and
    rank over the union.  Candidate sets are disjoint across gene ranges,
    so the result is the single-index run's.  On a CUDA device each shard
    takes the device build (``device_build=True``, as a mesh shard does,
    with the second key word for the search aux): the host build sorts a
    shard's 1.2e9-1.6e9 windows on the host, which takes minutes.  Each shard's index,
    its search aux with it, is freed before the next shard's build.
    ``timings``, when given, receives 'shards': per shard its gene range,
    the index build seconds and the matching seconds (host clock, ending
    in a synchronise) and its probe kind; the log's ``gene shard i/n``
    line gives the same."""
    device_build = torch.device(device).type == "cuda"
    bounds = np.searchsorted(
        np.asarray(ts.gene_start),
        np.linspace(0, int(ts.gene_start[-1]), nshards + 1),
    ).astype(np.int64)
    bounds[0], bounds[-1] = 0, ts.num_genes
    parts = []
    shard_times = []
    for si in range(nshards):
        lo, hi = int(bounds[si]), int(bounds[si + 1])
        if hi <= lo:
            continue
        t0 = time.perf_counter()
        index = build_target_index(gene_range(ts, lo, hi), cfg.WindowWidth, device,
                                   device_build=device_build)
        t1 = time.perf_counter()
        rows, kind = run_matching_indexed(cfg, rs, index, _defer_rank=True)
        del index
        t2 = time.perf_counter()
        rows[:, 1] += lo  # shard-local gene -> global gene
        parts.append(rows)
        shard_times.append(dict(genes=[lo, hi], build_s=t1 - t0, match_s=t2 - t1,
                                probe_kind=kind))
        logger.info(
            "gene shard %d/%d (genes [%d,%d)): %d survivors; %s build %.2fs, "
            "match %.2fs, probe %s",
            si + 1, nshards, lo, hi, len(rows), "device" if device_build else "host",
            t1 - t0, t2 - t1, kind,
        )
    if timings is not None:
        timings["shards"] = shard_times
    if not sum(len(p) for p in parts):
        z = np.zeros(0, dtype=np.int32)
        return MatchResult(z, z, z, z)
    rows = np.concatenate(parts)
    r, g, s, nx, grp, grp2, win = (rows[:, i] for i in range(fused.NCOL))
    r, g, s, nx = _apply_max_matches(cfg, r, g, s, nx, grp, grp2, win)
    return _dedup_and_rank(cfg, r, g, s, nx)


def _profiling() -> bool:
    """Whether torch.profiler records in this process now."""
    return bool(getattr(torch.autograd.profiler, "_is_profiler_enabled", False))


class _StageClock:
    """The spans of one call of the entry, summed over its batches.

    Device spans (``span``): CUDA events recorded on the stream that runs
    the block's work (the current one: inside ``torch.cuda.stream(s)``,
    ``s``), host perf_counter on the CPU.  Each span is booked to a batch
    (``tag``: the clock's current one unless the caller names another), so
    that a probe queued inside another batch's iteration still counts as
    its own batch's; the stages (STAGES) are device spans.  The sums wait
    for the device once, so a loop reads them after its end.

    Host spans (``host``): perf_counter.  With ``ranges`` (torch.profiler
    records), a host span also opens ``record_function("muscato." +
    name)``, which puts it on the profile's timeline beside the device's
    kernels; a block that enqueues work on the device, or waits in a copy
    from it, is timed with ``ranged=False``, since the profiler lays a
    range that encloses device work on the device's timeline too.

    Names are hierarchical: ``fetch.d2h`` is a part of the fetch.  With
    ``timed`` False (a call that only the profiler traces) the clock times
    nothing and records no event; its host spans still open their
    ranges."""

    STAGES = ("probe", "expand_verify", "rank")

    def __init__(self, device: torch.device, *, timed: bool = True, ranges: bool = False):
        self.cuda = device.type == "cuda"
        self.timed = timed
        self.ranges = ranges
        self.spans = []  # (device span name, batch tag, start, stop): events or times
        self.host_s = {}  # host span name -> seconds
        self.tag = 0  # the batch that spans are booked to by default

    def _now(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    @contextlib.contextmanager
    def span(self, name: str, tag=None):
        """Time the block as device span ``name`` of batch ``tag`` (the
        current batch when None)."""
        if not self.timed:
            yield
            return
        tag = self.tag if tag is None else tag
        a = self._now()
        yield
        self.spans.append((name, tag, a, self._now()))

    @contextlib.contextmanager
    def host(self, name: str, ranged: bool = True, timed: bool = True):
        """Time the block on the host as span ``name``; with ``ranged``, a
        block of host work alone, under a profiler range too.  With
        ``timed`` False the block only opens its range (a label for the
        profile's idle gaps that no timing reads)."""
        t = time.perf_counter()
        if self.ranges and ranged:
            with torch.profiler.record_function("muscato." + name):
                yield
        else:
            yield
        if self.timed and timed:
            self.host_s[name] = self.host_s.get(name, 0.0) + time.perf_counter() - t

    def batch_sums(self) -> dict:
        """Seconds by device span for each batch: {tag: {name: seconds}}."""
        if self.cuda:
            torch.cuda.synchronize()
        out = {}
        for name, tag, a, b in self.spans:
            dt = a.elapsed_time(b) / 1e3 if self.cuda else b - a
            sums = out.setdefault(tag, {})
            sums[name] = sums.get(name, 0.0) + dt
        return out

    def sums(self) -> dict:
        """Seconds by device span over every span."""
        out = {}
        for sums in self.batch_sums().values():
            for name, dt in sums.items():
                out[name] = out.get(name, 0.0) + dt
        return out


_NULL = contextlib.nullcontext()


def _span(clock: "_StageClock | None", name: str, tag=None):
    """``clock``'s device span ``name`` of batch ``tag``; nothing without a
    clock."""
    return _NULL if clock is None else clock.span(name, tag)


def _host_span(clock: "_StageClock | None", name: str, ranged: bool = True,
               timed: bool = True):
    """``clock``'s host span ``name``; nothing without a clock."""
    return _NULL if clock is None else clock.host(name, ranged, timed)


class _PinnedUploads:
    """Read-batch uploads to a CUDA device through two pinned host buffers
    used in turns: a batch's rows are staged into one, copied on a side
    stream without blocking the host, and the compute stream waits on the
    copy's event.  A buffer is refilled only after its previous copy has
    completed; the device tensors are allocated on the side stream and
    marked as used on the compute stream (``record_stream``), so that the
    allocator never hands their memory out while either stream uses it."""

    def __init__(self, device: torch.device):
        self.device = device
        self.side = torch.cuda.Stream(device)
        self.bufs = [None, None]  # (codes, lengths) pinned host tensors
        self.done = [None, None]  # the event of each buffer's last copy
        self.turn = 0

    def upload(self, codes: np.ndarray, lengths: np.ndarray, n: int,
               clock: "_StageClock | None" = None):
        """Device (codes (n, L) uint8, lengths (n,) int32): the given rows,
        then zero rows up to n; ready on the compute stream.  ``clock``
        times the wait on the buffer's previous copy (``wait.upload``),
        the host copy into it (``upload.stage``) and the copy to the
        device on the side stream (``upload.h2d``)."""
        i, self.turn = self.turn, self.turn ^ 1
        if self.done[i] is not None:
            with _host_span(clock, "wait.upload"):
                self.done[i].synchronize()
        shape = (n, codes.shape[1])
        with _host_span(clock, "upload.stage"):
            if self.bufs[i] is None or tuple(self.bufs[i][0].shape) != shape:
                self.bufs[i] = (torch.empty(shape, dtype=torch.uint8, pin_memory=True),
                                torch.empty(n, dtype=torch.int32, pin_memory=True))
            hc, hl = (t.numpy() for t in self.bufs[i])
            real_n = codes.shape[0]
            hc[:real_n] = codes
            hc[real_n:] = 0
            hl[:real_n] = lengths
            hl[real_n:] = 0
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.side):
            dc = torch.empty(shape, dtype=torch.uint8, device=self.device)
            dl = torch.empty(n, dtype=torch.int32, device=self.device)
            with _span(clock, "upload.h2d"):
                dc.copy_(self.bufs[i][0], non_blocking=True)
                dl.copy_(self.bufs[i][1], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.side)
        dc.record_stream(compute)
        dl.record_stream(compute)
        self.done[i] = ev
        compute.wait_event(ev)
        return dc, dl


def _host_scalar(x: torch.Tensor):
    """A function giving the 0-d ``x`` as a host int.  On a CUDA device the
    value is copied into pinned memory now, behind the work already
    queued, and the function waits on that copy's event only, not on work
    queued after this call."""
    if x.device.type != "cuda":
        return lambda: int(x)
    h = torch.empty((), dtype=x.dtype, pin_memory=True)
    h.copy_(x, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return lambda: (ev.synchronize(), int(h))[1]


class _BatchStages:
    """The stage calls of one read batch against one index, shared by
    ``run_matching_indexed`` and the device mesh (``parallel/mesh.py``):
    the probe, then the expand and verify up to the survivor buffer, with
    the survivor-capacity regrow.  ``agree`` in ``expand_verify`` gives
    the value every process of a mesh decides on (the world's maximum of
    its argument) and is the identity on one device: the 2**30 limit, the
    choice between the dedup and the streaming expand, and the regrow all
    follow it, so every process takes the same branch."""

    def __init__(self, cfg: Config, index: TargetIndex, l_eff: int, *,
                 index_aux=None, clock: "_StageClock | None" = None):
        sw = switches()
        self.cfg, self.index, self.l_eff = cfg, index, l_eff
        self.index_aux, self.clock = index_aux, clock
        self.allow_pjoin = sw["MUSCATO_PJOIN"]
        self.subchunk = sw["MUSCATO_PEXPAND_SUB"]
        self.prefetch = sw["MUSCATO_PREFETCH_PROBE"]
        self.q1s = tuple(int(q) for q in cfg.Windows)
        self.budget = torch.from_numpy(
            vops.mismatch_budget_table(cfg.PMatch, cfg.MaxReadLength)
        ).to(index.device)
        self.vchunk = cfg.MaxPairChunk or (1 << 20)
        self.pair_chunk = cfg.MaxPairChunk or (1 << 17)
        self.trows = index.trows(packed_ops.packed_width(l_eff))
        self.gblock, self.gsteps = index.gene_block()
        self.uploads = _PinnedUploads(index.device) if index.device.type == "cuda" else None
        self.chunks = 0  # streaming chunks run, re-runs included

    def _span(self, name: str, tag=None):
        return _span(self.clock, name, tag)

    def probe(self, rpacked, lengths, tag=None) -> fused.Probe:
        """The batch's probe, timed as batch ``tag``'s (the clock's current
        batch when None), the search probe's steps too."""
        with self._span("probe", tag):
            return fused.probe_windows(
                rpacked, lengths, self.q1s, self.index.skeys,
                width=self.cfg.WindowWidth, min_dinuc=self.cfg.MinDinuc,
                index_aux=self.index_aux, allow_pjoin=self.allow_pjoin,
                span=functools.partial(_span, self.clock, tag=tag),
            )

    def expand_verify(self, pr: fused.Probe, total: int, rpacked, lengths,
                      surv_cap: int, agree=int) -> tuple:
        """(survivor buffer, this batch's survivor count, survivor capacity
        after any regrow).  The buffer holds the live rows first and has
        ``_bucket_ceil`` of the agreed count rows, no more than the
        capacity."""
        cfg, index = self.cfg, self.index
        most = agree(total)
        if most > 2**30:
            raise ValueError(
                f"candidate pair count {most} in one read batch exceeds the "
                "2**30 expansion limit; re-run with a smaller ReadBatch (or "
                "raise MinDinuc)"
            )
        common = dict(width=cfg.WindowWidth, max_read_length=cfg.MaxReadLength,
                      smax=index.num_bases, trows=self.trows, gblock=self.gblock,
                      gsteps=self.gsteps, subchunk=self.subchunk)
        with self._span("expand_verify"):
            if len(self.q1s) <= 31 and not cfg.NoDedup and most <= _MAX_PAIR_CAP:
                pair_cap = max(_PAIR_FLOOR, _bucket_ceil(total))
                ver = fused.expand_verify_dedup(
                    pr, self.q1s, rpacked, lengths, index.spos, index.gene_start,
                    self.budget, pair_cap=pair_cap,
                    vchunk=min(self.vchunk, pair_cap), **common,
                )
                with _host_span(self.clock, "wait.survivors", ranged=False):
                    nsurv = int(ver.nsurv)
                need = agree(nsurv)
                # Survivor-capacity regrow: the sorted survivors are all on
                # the device, so growing the buffer re-runs nothing.
                while need > surv_cap:
                    surv_cap = max(surv_cap * 2, _bucket_ceil(need))
                buf = fused.survivor_rows(
                    ver, pr.keyf, pr.key2f, nreads=rpacked.shape[0],
                    nwin=len(self.q1s), surv_cap=min(surv_cap, _bucket_ceil(need)),
                )
            else:
                # The streaming expand writes survivors in chunk order and
                # drops those past the buffer, so an overflow re-runs the
                # stage with the grown capacity (the probe is reused), as
                # the JAX engine does.
                while True:
                    st = fused.expand_verify_streamed(
                        pr, self.q1s, rpacked, lengths, index.spos,
                        index.gene_start, self.budget, pair_chunk=self.pair_chunk,
                        surv_cap=surv_cap, total=total, **common,
                    )
                    self.chunks += st.chunks
                    with _host_span(self.clock, "wait.survivors", ranged=False):
                        nsurv = int(st.nsurv)
                    need = agree(nsurv)
                    if need <= surv_cap:
                        break
                    surv_cap = max(surv_cap * 2, _bucket_ceil(need))
                buf = st.surv[: _bucket_ceil(need)]
        return buf, nsurv, surv_cap


def _read_width(lengths: np.ndarray, ncols: int, width: int) -> int:
    """Columns of the read matrix that the packed reads keep: the longest
    read (at least the window width), at most ``ncols``."""
    l_eff = int(max(int(np.max(lengths, initial=0)), width))
    return min(l_eff, ncols) or ncols


def run_matching_indexed(cfg: Config, rs: ReadSet, index: TargetIndex,
                         probe: str | None = None,
                         timings: dict | None = None,
                         _defer_rank: bool = False):
    """Match a ReadSet against a prebuilt index on the index's device.

    probe: None auto-selects as the JAX engine does: the search probe
    (direct or binary, per the index's SearchAux) when the index holds
    more than 64 window keys per query of a batch, else the sorted-join
    probe; 'sort' takes the sorted join, 'search' the search probe.
    MUSCATO_PJOIN=0 replaces the sorted join by the sort-merge probe, and
    MUSCATO_PEXPAND_SUB=1 expands on B6.  With MUSCATO_PREFETCH_PROBE on
    (unset or "1"), batch N+1's reads are uploaded and its probe queued
    before the loop blocks on batch N's pair total; "0" still uploads
    batch N+1 then, but queues its probe in its own turn, as the JAX
    switch does.  All of these give the same MatchResult.
    MUSCATO_STAGE_TIMES=1 logs, for each batch, the JAX engine's line
    "stage times [b0,b1): host_stage=... probe=... expand_verify=...
    rank=... total=..." (host_stage: the host seconds spent staging the
    next batch, its upload and with prefetch its probe's queuing; probe,
    expand_verify and rank: the batch's stage spans, CUDA-event device
    time on a GPU; total: the batch's host wall) and their "stage sums
    over N batches", then the port's own line "kernel launches over N
    batches: name=count ..." (each CUDA kernel's launches in this run;
    none on the CPU, where the plain twins run).  It logs them all after
    the loop, so that the clock waits for the device once and adds no
    sync to the loop.  _defer_rank returns the raw (N, NCOL) rows, ranked
    per batch with every column, and the probe kind instead of the
    MatchResult (gene-range sharding ranks the union of its shards).

    timings, when given, receives per-stage seconds under 'stages' (probe,
    expand_verify, rank; CUDA-event device time on a GPU), the host
    seconds spent staging and uploading read batches ('read_prep_s'), the
    batch loop's wall time up to the row fetch, the union of several
    batches included ('device_s'), the seconds and bytes of fetching and
    unpacking the retained rows ('fetch_s', 'fetch_bytes'), 'pairs' (the
    candidate pair total), 'batches',
    'chunks' (the streaming expand's chunks run, re-runs after a survivor
    overflow included; 0 when every batch took the dedup expand),
    'probe_kind' (direct, binary, sorted_join or sort_merge), 'spans'
    ({name: seconds} summed over the batches, below) and 'counts' (the
    call's 'reads', the 'survivors' of its verify and the rows its rank
    'retained', each summed over the batches, and over several batches
    the rows their union keeps, 'union_kept').

    The spans, parts of the keys above: 'prepare' (host: the checks
    before the loop, the probe's choice, the search aux and the stage
    set-up), the upload's 'upload.stage' (host: the copy into the pinned
    buffer, or on the CPU into the tensors) and 'upload.h2d' (device, on
    the upload's side stream), 'read_pack' (device: the nibble pack), the
    host's waits on the device, 'wait.upload' (a pinned buffer's previous
    copy), 'wait.total' (the pair total), 'wait.survivors' and
    'wait.count' (a batch's rank, and the union's), the search probe's
    'probe.queries', 'probe.search' and 'probe.compact' (device: its
    window queries and their sort, B8 or B9, the compaction; parts of the
    stage 'probe'), the rank's 'rank.cap'
    and 'rank.dedup' (device), over several batches the union's
    'union.cap' (device: its rank's cap) and 'union.rank' (device: its
    dedup, best+MMTol and compaction), the fetch's 'fetch.d2h' and, where
    the rows come back packed, 'fetch.unpack' (host), then 'assemble'
    (host: the concatenation and the MatchResult's columns).  While
    torch.profiler records, with or without ``timings``, each host span
    that encloses host work alone opens
    ``record_function("muscato.<name>")``: prepare (its checks),
    upload.stage, wait.upload, wait.total, fetch.unpack and assemble.
    Without ``timings``,
    MUSCATO_STAGE_TIMES or a profiler, the call records no CUDA event and
    opens no range."""
    if probe not in (None, "sort", "search"):
        raise ValueError(f"probe must be None, 'sort' or 'search', got {probe!r}")
    device = index.device
    stage_times = os.environ.get("MUSCATO_STAGE_TIMES") == "1"
    ranges = _profiling()
    timed = timings is not None or stage_times
    clock = _StageClock(device, timed=timed, ranges=ranges) if timed or ranges else None
    with _host_span(clock, "prepare"):
        width = cfg.WindowWidth
        # Trim the packed read matrix to the longest actual read.
        l_eff = _read_width(rs.lengths, rs.codes.shape[1], width)
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

        # Probe auto-selection, as the JAX engine makes it: the sorted join
        # sorts a batch's queries and joins them against the whole index; the
        # search probe touches only the queried entries, and wins for a small
        # batch against a huge index (crossover set at V > 64 queries).
        nflat = len(q1s) * min(batch, _round_up(nreads, 1024))
        if probe is None:
            use_search = index.skeys.shape[0] > 64 * nflat
        else:
            use_search = probe == "search"
        # The batches' rows keep the group columns where a union caps them
        # again (several batches, or the gene-range shards); the call's
        # rows come back 64-bit packed, over the call's read range, unless
        # they are the shards' raw rows.
        full_cols = _defer_rank or nbatches > 1
        pack_bits = None if _defer_rank else _fetch_pack_bits(
            index, batch if nbatches == 1 else _round_up(nreads, 1024), cfg)
    # The search aux's build and the budget table's upload run on the device.
    with _host_span(clock, "prepare", ranged=False):
        index_aux = index.search_aux() if use_search else None
        if stage_times:
            launches0 = {k: f.launches for k, f in KERNELS.items()}
            batch_walls = []  # (b0, b1, host_stage, total) of each batch
        stages = _BatchStages(cfg, index, l_eff, index_aux=index_aux, clock=clock)
        kind = fused.probe_kind(index_aux, stages.allow_pjoin)
        logger.info(
            "probe: %s (%d index keys, %d queries a batch%s)", kind,
            index.skeys.shape[0], nflat,
            f", aux {index_aux.nbytes} bytes built in {index_aux.build_s:.2f}s"
            if index_aux is not None else "",
        )
        surv_cap = max(_CAP_HINT[0], _SURV_CAP0)
    read_prep_s = 0.0

    def load(b0):
        nonlocal read_prep_s
        t = time.perf_counter()
        out = _device_read_batch(rs, b0, b0 + batch, l_eff, device,
                                 cache_ok=nbatches == 1, uploads=stages.uploads,
                                 clock=clock)
        read_prep_s += time.perf_counter() - t
        return out

    t_run0 = time.perf_counter()
    surv_rows = []
    total_pairs = total_surv = total_kept = 0
    nxt = load(0)
    pr_next = None
    for b0 in range(0, nreads, batch):
        t_batch = time.perf_counter()
        b1 = min(b0 + batch, nreads)
        if clock is not None:
            clock.tag = b0
        rpacked, lengths = nxt
        pr = pr_next if pr_next is not None else stages.probe(rpacked, lengths)
        pr_next = None
        get_total = _host_scalar(pr.total)
        st_host = 0.0
        if b0 + batch < nreads:
            # Batch N+1's upload, and with MUSCATO_PREFETCH_PROBE on its
            # probe, go in behind batch N's probe, before the loop blocks
            # on batch N's total; they read only batch N+1's reads and the
            # index.
            t_hs = time.perf_counter()
            nxt = load(b0 + batch)
            if stages.prefetch:
                pr_next = stages.probe(*nxt, tag=b0 + batch)
            st_host = time.perf_counter() - t_hs
        with _host_span(clock, "wait.total"):
            total = get_total()
        buf, nsurv, surv_cap = stages.expand_verify(pr, total, rpacked, lengths, surv_cap)
        _CAP_HINT[0] = surv_cap
        total_pairs += total
        total_surv += nsurv
        count = 0
        if nsurv:
            # The rank sorts every row it is given, so it takes the live
            # rows' bucket, not the (hinted) capacity: the buffer holds
            # its live rows first.
            with stages._span("rank"):
                rows_dev, count_d = fused.rank_survivors(
                    buf, nsurv, cfg.MaxMatches, cfg.MMTol,
                    match_mode=cfg.MatchMode, full_cols=full_cols,
                    pack_bits=pack_bits, span=functools.partial(_span, clock),
                )
                with _host_span(clock, "wait.count", ranged=False):
                    count = int(count_d)
                rows_dev = rows_dev[:count]
                if b0:
                    rows_dev[:, 0] += b0  # batch-local read row -> global row
            surv_rows.append(rows_dev)
        total_kept += count
        dt = time.perf_counter() - t_batch
        if stage_times:
            batch_walls.append((b0, b1, st_host, dt))
        logger.info(
            "batch reads [%d,%d): %d pairs, %d survivors, %d retained, "
            "%.2fs (%.0f reads/s)",
            b0, b1, total, nsurv, count, dt, (b1 - b0) / max(dt, 1e-9),
        )
    union = nbatches > 1 and not _defer_rank
    if union:
        surv_rows, union_kept = _device_union(cfg, surv_rows, pack_bits, clock)
    device_s = time.perf_counter() - t_run0

    if stage_times:
        by_batch = clock.batch_sums()
        sums = dict.fromkeys(("host_stage", "probe", "expand_verify", "rank"), 0.0)
        for b0, b1, st_host, dt in batch_walls:
            sb = {k: by_batch.get(b0, {}).get(k, 0.0) for k in sums}
            sb["host_stage"] = st_host
            for k in sums:
                sums[k] += sb[k]
            logger.info(
                "stage times [%d,%d): host_stage=%.3f probe=%.3f "
                "expand_verify=%.3f rank=%.3f total=%.3f",
                b0, b1, sb["host_stage"], sb["probe"],
                sb["expand_verify"], sb["rank"], dt,
            )
        logger.info(
            "stage sums over %d batches: host_stage=%.3f probe=%.3f "
            "expand_verify=%.3f rank=%.3f",
            nbatches, sums["host_stage"], sums["probe"],
            sums["expand_verify"], sums["rank"],
        )
        logger.info("kernel launches over %d batches: %s", nbatches, " ".join(
            f"{k}={f.launches - launches0[k]}" for k, f in KERNELS.items()))
    t_fetch = time.perf_counter()
    fetched = []
    for rows_dev in surv_rows:
        with _host_span(clock, "fetch.d2h", ranged=False):
            rows = rows_dev.cpu().numpy()
        if pack_bits is not None:
            with _host_span(clock, "fetch.unpack"):
                rows = _unpack_rows64(rows, pack_bits)
        fetched.append(rows)
    fetch_s = time.perf_counter() - t_fetch
    logger.info(
        "windows %s: %d candidate pairs, %d retained",
        cfg.Windows, total_pairs, sum(len(x) for x in fetched),
    )
    out = _assemble(fetched, clock, rows_only=_defer_rank)

    if timings is not None:
        # The clock's reads (a device synchronise, the events) come after
        # every window they time.
        dev = clock.sums()
        timings["stages"] = {k: v for k, v in dev.items() if k in _StageClock.STAGES}
        timings["read_prep_s"] = read_prep_s
        timings["device_s"] = device_s
        timings["fetch_s"] = fetch_s
        timings["fetch_bytes"] = sum(r.numel() * r.element_size() for r in surv_rows)
        timings["pairs"] = total_pairs
        timings["batches"] = nbatches
        timings["chunks"] = stages.chunks
        timings["probe_kind"] = kind
        timings["spans"] = {**{k: v for k, v in dev.items() if k not in _StageClock.STAGES},
                            **clock.host_s}
        timings["counts"] = dict(reads=nreads, survivors=total_surv, retained=total_kept)
        if union:
            timings["counts"]["union_kept"] = union_kept
    return (out, kind) if _defer_rank else out


def _device_union(cfg: Config, parts: list, pack_bits, clock: "_StageClock | None"):
    """The union of several batches' retained rows (device, full columns,
    global read rows), capped and ranked again by the batches' own rank on
    the device: the k-mer cap groups span batches.  Returns the list of the
    one buffer to fetch (64-bit packed with ``pack_bits``, else the four
    int32 columns) and its row count.  ``clock`` times the rank's cap as
    the device span ``union.cap`` and its dedup, best+MMTol and compaction
    as ``union.rank``; the host waits for the count in ``wait.count``."""
    if not parts:
        return [], 0
    rows = torch.cat(parts)
    with contextlib.ExitStack() as rest:
        def span(name):
            if name == "rank.cap":
                return _span(clock, "union.cap")
            # The dedup opens union.rank, which closes at the rank's end.
            rest.enter_context(_span(clock, "union.rank"))
            return _NULL

        out, count_d = fused.rank_survivors(
            rows, rows.shape[0], cfg.MaxMatches, cfg.MMTol, match_mode=cfg.MatchMode,
            full_cols=False, pack_bits=pack_bits, span=span,
        )
    with _host_span(clock, "wait.count", ranged=False):
        count = int(count_d)
    return [out[:count]], count


def _assemble(fetched: list, clock: "_StageClock | None", *, rows_only: bool):
    """The call's result from the fetched rows, already in canonical
    (read, gene, start) order: the raw (N, NCOL) rows with ``rows_only``,
    else the MatchResult.  Timed as ``assemble`` (the concatenation and
    the columns)."""
    with _host_span(clock, "assemble"):
        if rows_only:
            return (np.concatenate(fetched) if fetched
                    else np.zeros((0, fused.NCOL), dtype=np.int32))
        if not fetched:
            z = np.zeros(0, dtype=np.int32)
            return MatchResult(z, z, z, z)
        rows = np.concatenate(fetched)
        return MatchResult(
            rows[:, 0].copy(), rows[:, 1].copy(),
            rows[:, 2].copy(), rows[:, 3].copy(),
        )


def _fetch_pack_bits(index: TargetIndex, batch: int, cfg: Config):
    """Static bit widths (rbits, gbits, sbits, xbits) for the 64-bit packed
    retained-row fetch of read rows below ``batch``, or None when the
    fields cannot fit."""
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


def preload_device_batch(cfg: Config, rs: ReadSet, device) -> None:
    """Stage a single-batch ReadSet's device arrays ahead of a run (cached
    on the ReadSet, as the JAX package's ``preload_device_batch`` does), so
    that a benchmark's timed runs leave the upload out."""
    l_eff = _read_width(rs.lengths, rs.codes.shape[1], cfg.WindowWidth)
    nreads = rs.codes.shape[0]
    batch = cfg.ReadBatch or (1 << 22)
    batch = min(batch, _round_up(nreads, 1024))
    if nreads <= batch:
        _device_read_batch(rs, 0, batch, l_eff, torch.device(device), cache_ok=True)


def _device_read_batch(rs: ReadSet, b0: int, b1: int, l_eff: int, device,
                       cache_ok: bool = False, uploads: _PinnedUploads | None = None,
                       clock: _StageClock | None = None):
    """Device tensors (rpacked int32 (n, nw), lengths int32 (n,)) for read
    rows [b0, b1), padded to the batch size with empty rows.  The uint8
    codes are uploaded (on a CUDA device through a pinned buffer of
    ``uploads``, or of a new one) and nibble-packed on the device: packing
    a 4M-read batch on the host took most of the flagship's wall time.
    With ``cache_ok`` (single-batch runs) the result is kept on the
    ReadSet for later runs; multi-batch runs never cache, so resident read
    memory stays one batch.  ``clock`` times the upload's parts
    (``_upload_rows``)."""
    device = torch.device(device)
    cache = getattr(rs, "_dev_cache", None)
    key = (b0, b1, l_eff, str(device))
    if cache is not None and key in cache:
        return cache[key]
    out = _upload_rows(rs.codes[b0:b1, :l_eff], rs.lengths[b0:b1], b1 - b0,
                       device, uploads, clock)
    if cache_ok:
        if cache is None:
            cache = rs._dev_cache = {}
        cache[key] = out
    return out


def _upload_rows(codes: np.ndarray, lengths: np.ndarray, n: int, device,
                 uploads: _PinnedUploads | None = None,
                 clock: _StageClock | None = None):
    """Device tensors (rpacked int32 (n, nw), lengths int32 (n,)) of the
    host rows ``codes`` (uint8, already cut to the packed width) and
    ``lengths``, then zero rows up to n.  ``clock`` times the host copy
    (``upload.stage``; on the CPU the copy into the tensors), the upload
    (``_PinnedUploads.upload``) and the nibble pack (``read_pack``)."""
    lens = np.asarray(lengths, dtype=np.int32)
    if device.type == "cuda":
        dc, dl = (uploads or _PinnedUploads(device)).upload(codes, lens, n, clock)
    else:
        with _host_span(clock, "upload.stage"):
            dc = torch.zeros((n, codes.shape[1]), dtype=torch.uint8)
            dl = torch.zeros(n, dtype=torch.int32)
            dc.numpy()[: codes.shape[0]] = codes
            dl.numpy()[: codes.shape[0]] = lens
    with _span(clock, "read_pack"):
        return packed_ops.pack_rows(dc), dl


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
