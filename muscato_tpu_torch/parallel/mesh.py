"""The device mesh: gene-range index shards over "mp", read blocks over
"dp" (port of ``muscato_tpu/parallel/mesh.py`` to ``torch.distributed``).

The JAX mesh is one ``shard_map`` over the devices of a
``jax.sharding.Mesh``.  Here each mesh position is a process of its own:

  - rank r is position (d, m) = (r // mp, r % mp) and holds one device;
  - shard m of the targets, a contiguous gene range with roughly equal
    base counts (``shard_bounds``, the JAX rule), is indexed by the ranks
    of column m alone, each building only its own shard, on its device;
  - each read batch is padded to a multiple of dp with zero rows and cut
    into dp blocks; the ranks of row d take block d;
  - each rank runs the single-device engine's stages on its block against
    its shard (``engine.pipeline._BatchStages``: the sorted join, or the
    sort-merge probe under MUSCATO_PJOIN=0, then the dedup or the
    streaming expand and the verify), with every branch taken on values
    reduced over the world, so that the ranks stay in lockstep;
  - the survivor buffers of a dp row meet in one all-gather over its mp
    group, and the row's m == 0 rank ranks them on its device (the same
    cap, dedup and best+MMTol as one device);
  - that rank sends its retained rows, with global read rows, to rank 0,
    which runs the cross-batch cap and rank on the host as one device
    does.  The other ranks return an empty MatchResult.

Each dp row's mp ranks form a process group (``dist.new_group``) for the
all-gather; the lockstep reductions and the rows sent to rank 0 go over
the world when its backend is gloo, else over a gloo group of the world,
always as CPU tensors.  The all-gather runs on the world's backend, on
the device's tensors: NCCL for ranks with a card each, gloo on the CPU,
and gloo for ranks that share one card by the caller's choice
(``dist.initialize``; gloo's all-gather takes CUDA tensors and stages
them through host memory itself).  A mesh of one process without a
process group runs the same stages with no collective.

The JAX package's window ladders, ``_globalize_inputs``,
``_addressable_by_dp``, ``_mesh_key`` and ``_JIT_CACHE`` are not ported:
the port's kernels have no window, and each process holds its own
tensors.
"""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config
from ..device import rank_device
from ..engine import pipeline as pl
from ..engine.index import TargetIndex, build_target_index
from ..io.reads import ReadSet
from ..io.targets import TargetSet
from ..ops import fused

logger = logging.getLogger("muscato.pipeline")

# Each collective of a mesh fails after this long: a rank that leaves
# lockstep stops the others instead of hanging them.
TIMEOUT = timedelta(minutes=10)


def shard_bounds(ts: TargetSet, num_shards: int) -> list:
    """First gene of each of ``num_shards`` contiguous gene ranges with
    roughly equal base counts, then the gene count (the JAX
    ``shard_targets`` rule: a range ends at the first gene whose running
    base count reaches its share; ranges past the genes are empty)."""
    g = ts.num_genes
    sizes = np.diff(np.asarray(ts.gene_start))
    total = int(ts.gene_start[-1])
    bounds = [0]
    acc = 0
    per = total / num_shards if num_shards else total
    for i in range(g):
        acc += int(sizes[i])
        if acc >= per * len(bounds) and len(bounds) < num_shards:
            bounds.append(i + 1)
    while len(bounds) < num_shards:
        bounds.append(g)
    bounds.append(g)
    return bounds


@dataclass
class Shard:
    """One rank's gene-range shard: the index of genes [lo, hi) (gene ids
    local to the shard) on the rank's device."""

    index: TargetIndex
    genes: tuple  # (lo, hi)

    @property
    def gene_base(self) -> int:
        """The shard's first global gene."""
        return self.genes[0]


def shard_targets(ts: TargetSet, width: int, num_shards: int, shard: int,
                  device) -> Shard:
    """Build shard ``shard`` of ``num_shards`` (``shard_bounds``) on
    ``device``, keys and sort computed there (``device_build``, as the JAX
    mesh builds every shard) without the second key word, which the mesh
    never reads; no other shard is built."""
    bounds = shard_bounds(ts, num_shards)
    lo, hi = bounds[shard], bounds[shard + 1]
    index = build_target_index(pl.gene_range(ts, lo, hi), width, device, device_build=True,
                               keep_k2=False)
    return Shard(index, (lo, hi))


@dataclass
class Mesh:
    """This process's place in a dp x mp mesh: its rank, its device, the
    process group of its dp row, and the world's backend (None: one
    process with no process group)."""

    dp: int
    mp: int
    rank: int
    device: torch.device
    backend: str | None
    mp_group: object = None
    host_group: object = None  # gloo group of the world; None: the world

    @property
    def d(self) -> int:
        return self.rank // self.mp

    @property
    def m(self) -> int:
        return self.rank % self.mp

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "mp": self.mp}

    def agree_max(self, x: int) -> int:
        """The world's maximum of ``x`` (a lockstep decision)."""
        if self.backend is None:
            return int(x)
        t = torch.tensor([int(x)], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.host_group)
        return int(t)

    def all_gather_mp(self, t: torch.Tensor) -> torch.Tensor:
        """(mp, *t.shape): ``t`` of every rank of this dp row, in m order,
        on t's device.  Every member passes the same shape."""
        if self.backend is None:
            return t[None]
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.mp)]
        dist.all_gather(parts, t, group=self.mp_group)
        return torch.stack(parts)


def make_mesh(dp: int, mp: int, device="cuda") -> Mesh:
    """The dp x mp mesh over the world of ``torch.distributed`` (one
    process, with no process group, when none is initialised).  The world
    must have exactly dp * mp processes.  ``device`` is this process's
    device (``device.rank_device``: a bare "cuda" is cuda:LOCAL_RANK).
    Every process of the world calls this together: it creates the
    groups."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = dp * mp
    if n > world:
        raise ValueError(f"mesh {dp}x{mp} needs {n} devices, have {world}")
    if n < world:
        raise ValueError(
            f"mesh {dp}x{mp} takes {n} processes, the world has {world}: "
            "a mesh spans the whole world"
        )
    dev = rank_device(device)
    if not dist.is_initialized():
        return Mesh(dp, mp, 0, dev, None)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = dist.get_backend()
    rank = dist.get_rank()
    mp_group = None
    for d in range(dp):
        g = dist.new_group(list(range(d * mp, (d + 1) * mp)), timeout=TIMEOUT)
        if d == rank // mp:
            mp_group = g
    host_group = None if backend == "gloo" else dist.new_group(backend="gloo", timeout=TIMEOUT)
    return Mesh(dp, mp, rank, dev, backend, mp_group, host_group)


def _add(timings: dict | None, key: str, value) -> None:
    if timings is not None:
        timings[key] = timings.get(key, 0) + value


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _rank_gathered(cfg: Config, buf: torch.Tensor, nsurv: int, gene_base: int,
                   mesh: Mesh, stages, timings: dict | None):
    """Make the survivor rows' genes global, all-gather the dp row's
    buffers and survivor counts over its mp group, and on the row's
    m == 0 rank rank the gathered rows on the device (``fused._rank_core``
    with every column: the cross-batch cap needs the group columns).
    Returns (retained rows on the device, their count) on that rank, and
    (None, 0) on the others, which send nothing."""
    n = buf.shape[0]
    dev = buf.device
    live = torch.arange(n, device=dev) < nsurv
    buf = buf.clone()
    buf[:, 1] += live.to(torch.int32) * gene_base
    buf[~live] = -1
    if timings is not None:
        _sync(dev)
    t0 = time.perf_counter()
    gathered = mesh.all_gather_mp(buf)
    counts = mesh.all_gather_mp(torch.tensor([nsurv], dtype=torch.int64, device=dev))
    if timings is not None:
        _sync(dev)
    _add(timings, "allgather_s", time.perf_counter() - t0)
    _add(timings, "allgather_bytes", (mesh.mp - 1) * (buf.numel() * 4 + 8))
    if mesh.m != 0:
        return None, 0
    # The live mask comes from each member's count, never from the rows.
    off = torch.arange(mesh.mp * n, device=dev)
    live_flat = (off % n) < counts.reshape(-1)[off // n]
    with stages._span("rank"):
        rows, count = fused._rank_core(
            gathered.reshape(-1, fused.NCOL), live_flat, cfg.MaxMatches,
            cfg.MMTol, match_mode=cfg.MatchMode, full_cols=True,
        )
        count = int(count)
    return rows[:count], count


def _gather_rows_to_primary(local: np.ndarray, mesh: Mesh, timings: dict | None):
    """Send the m == 0 ranks' retained rows to rank 0 over the gloo group:
    rank 0 returns its own rows and every sender's, in d order; the other
    ranks return None and receive nothing.  A sender's row count goes
    first, and a sender with no rows sends nothing more.  Each transfer
    waits at most MUSCATO_MERGE_TIMEOUT_MS (600,000 when unset)."""
    timeout = timedelta(milliseconds=int(os.environ.get("MUSCATO_MERGE_TIMEOUT_MS", "600000")))
    group = mesh.host_group
    t0 = time.perf_counter()
    nbytes = 0
    out = None
    if mesh.backend is None:
        out = local
    elif mesh.rank == 0:
        parts = [local]
        for d in range(1, mesh.dp):
            src = d * mesh.mp
            n = torch.zeros(1, dtype=torch.int64)
            dist.irecv(n, src, group=group).wait(timeout)
            if int(n):
                rows = torch.empty((int(n), fused.NCOL), dtype=torch.int32)
                dist.irecv(rows, src, group=group).wait(timeout)
                parts.append(rows.numpy())
                nbytes += rows.numel() * 4
        out = np.concatenate(parts)
    elif mesh.m == 0:
        rows = torch.from_numpy(np.ascontiguousarray(local, dtype=np.int32))
        dist.isend(torch.tensor([len(rows)], dtype=torch.int64), 0, group=group).wait(timeout)
        if len(rows):
            dist.isend(rows, 0, group=group).wait(timeout)
            nbytes += rows.numel() * 4
    _add(timings, "gather_s", time.perf_counter() - t0)
    _add(timings, "gather_bytes", nbytes)
    return out


def sharded_match_arrays(cfg: Config, codes: np.ndarray, lengths: np.ndarray,
                         shard: Shard, mesh: Mesh, surv_cap: int = 1 << 14,
                         timings: dict | None = None, *, stages=None):
    """One read batch over the mesh: this rank's block of ``codes`` /
    ``lengths`` (the whole batch, the same on every rank) against its
    shard, the mp all-gather and rank, and the rows to rank 0.

    Returns ((r, g, s, nx, grp, grp2, window) int32 arrays of the retained
    rows with global read rows and genes: every row of the batch on rank
    0, none elsewhere; the survivor capacity after any regrow, the same on
    every rank).  ``stages`` (``pipeline._BatchStages`` of the shard's
    index) is built for the batch when not given.  ``timings``, when
    given, accumulates 'pack_s' (host seconds to stage the block and queue
    its upload and nibble-pack), 'upload_s' (the same until the device
    holds the packed block), 'device_s' (probe to the retained count),
    'fetch_s' (the retained rows to the host), 'allgather_s' and
    'allgather_bytes' (what this rank received), and 'gather_s' and
    'gather_bytes' (the rows sent to, or received by, rank 0)."""
    r_total = codes.shape[0]
    per = -(-r_total // mesh.dp)  # the batch padded to a multiple of dp
    device = shard.index.device
    if stages is None:
        l_eff = pl._read_width(lengths, codes.shape[1], cfg.WindowWidth)
        stages = pl._BatchStages(cfg, shard.index, l_eff)
    lo = mesh.d * per
    t0 = time.perf_counter()
    rpacked, lens = pl._upload_rows(codes[lo : lo + per, : stages.l_eff],
                                    lengths[lo : lo + per], per, device, stages.uploads)
    _add(timings, "pack_s", time.perf_counter() - t0)
    if timings is not None:
        _sync(device)
    _add(timings, "upload_s", time.perf_counter() - t0)

    t0 = time.perf_counter()
    pr = stages.probe(rpacked, lens)
    total = int(pr.total)
    buf, nsurv, surv_cap = stages.expand_verify(
        pr, total, rpacked, lens, surv_cap, agree=mesh.agree_max
    )
    rows, count = _rank_gathered(cfg, buf, nsurv, shard.gene_base, mesh, stages, timings)
    _add(timings, "device_s", time.perf_counter() - t0)

    t0 = time.perf_counter()
    local = np.zeros((0, fused.NCOL), dtype=np.int32)
    if rows is not None:
        local = rows.cpu().numpy()
        local[:, 0] += lo  # block read row -> batch read row
        local = local[local[:, 0] < r_total]  # the pad rows' matches
    _add(timings, "fetch_s", time.perf_counter() - t0)
    logger.info(
        "mesh rank %d (d=%d, m=%d): %d pairs, %d survivors, %d retained",
        mesh.rank, mesh.d, mesh.m, total, nsurv, count,
    )
    z = _gather_rows_to_primary(local, mesh, timings)
    if z is None:
        z = np.zeros((0, fused.NCOL), dtype=np.int32)
    return tuple(z[:, i] for i in range(fused.NCOL)), surv_cap


# Process-wide survivor-capacity hint of the mesh path (the analogue of
# engine.pipeline._CAP_HINT): a regrown capacity persists across batches
# and runs.
_CAP_HINT = [1 << 14]


def run_matching_sharded(cfg: Config, rs: ReadSet, shard: Shard, mesh: Mesh,
                         timings: dict | None = None) -> pl.MatchResult:
    """Every read batch over the mesh, then on rank 0 the same cap, dedup
    and rank over the union as one device runs; the other ranks return an
    empty MatchResult.  Every rank of the world calls this with the same
    ReadSet.  ``timings``, when given, receives the sums of
    ``sharded_match_arrays``'s keys over the batches, 'stages' (probe,
    expand_verify and rank seconds; CUDA-event time on a GPU) and
    'batches'.  Under MUSCATO_STAGE_TIMES=1 the rank logs those sums
    ("mesh timings over N batches: {json}") and, as the single-device
    loop does, "kernel launches over N batches: name=count ..."."""
    stage_times = os.environ.get("MUSCATO_STAGE_TIMES") == "1"
    if stage_times:
        launches0 = {k: f.launches for k, f in pl.KERNELS.items()}
        timings = {} if timings is None else timings
    nreads = rs.codes.shape[0]
    width = cfg.WindowWidth
    batch = cfg.ReadBatch or (1 << 22)
    batch = min(batch, pl._round_up(nreads, 1024 * mesh.dp))
    batch = pl._round_up(batch, mesh.dp)

    for k, q1 in enumerate(cfg.Windows):
        if not pl._window_has_reads(rs, q1, width):
            raise SystemExit(f"Window {k} produced no valid reads, exiting")

    clock = pl._StageClock(shard.index.device) if timings is not None else None
    stages = pl._BatchStages(
        cfg, shard.index, pl._read_width(rs.lengths, rs.codes.shape[1], width), clock=clock
    )
    surv_cap = mesh.agree_max(max(_CAP_HINT[0], 1 << 14))
    all_rows = []
    for b0 in range(0, nreads, batch):
        t_batch = time.perf_counter()
        b1 = min(b0 + batch, nreads)
        cols, surv_cap = sharded_match_arrays(
            cfg, rs.codes[b0:b1], rs.lengths[b0:b1], shard, mesh, surv_cap,
            timings, stages=stages,
        )
        _CAP_HINT[0] = surv_cap
        rows = np.stack(cols, axis=1)
        rows[:, 0] += b0
        all_rows.append(rows)
        dt = time.perf_counter() - t_batch
        logger.info(
            "mesh batch reads [%d,%d): %d rows at rank %d, %.2fs (%.0f reads/s)",
            b0, b1, len(rows), mesh.rank, dt, (b1 - b0) / max(dt, 1e-9),
        )
    if timings is not None:
        timings["stages"] = clock.sums()
        timings["batches"] = len(all_rows)
    if stage_times:
        logger.info("mesh timings over %d batches: %s", len(all_rows),
                    json.dumps(timings, sort_keys=True))
        logger.info("kernel launches over %d batches: %s", len(all_rows), " ".join(
            f"{k}={f.launches - launches0[k]}" for k, f in pl.KERNELS.items()))

    z = np.zeros(0, dtype=np.int32)
    if mesh.rank != 0:
        logger.info("mesh rank %d: the rank runs on rank 0", mesh.rank)
        return pl.MatchResult(z, z, z, z)
    rows = np.concatenate(all_rows) if all_rows else np.zeros((0, fused.NCOL), np.int32)
    if not len(rows):
        return pl.MatchResult(z, z, z, z)
    r, g, s, nx, grp, grp2, win = (rows[:, i] for i in range(fused.NCOL))
    r, g, s, nx = pl._apply_max_matches(cfg, r, g, s, nx, grp, grp2, win)
    return pl._dedup_and_rank(cfg, r, g, s, nx)
