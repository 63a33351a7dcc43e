"""Top-level run driver of the ``muscato_torch`` entry point (port of the
single-device branch of ``muscato_tpu/engine/driver.py``).

The observable behavior is the JAX driver's: a uuid run id names
muscato_tmp/<uuid>/ and muscato_logs/<uuid>/, the merged config goes to
LogDir/config.json, per-stage log files and seqinfo.json land in LogDir,
reads_sorted.txt.sz and matches.npz go to TempDir (removed at exit unless
NoCleanTemp), and results.txt, the nonmatch fastq, readstats and genestats
are written byte for byte as the JAX package writes them.  IndexFile
loads the sorted target index from its file when the file exists, else
builds it and saves it there; ResumeDir reuses an earlier run's
matches.npz and skips the index and the matching.  The compute stages run
on the ``device`` given to ``run``.

A multi-process run starts its process group from ``--Coordinator``/
``--ProcessCount``/``--ProcessIndex``, or from torchrun's environment
(``parallel/dist.py``; MUSCATO_DIST_BACKEND=gloo lets processes share one
card), and runs one process a device: each parses its byte range of the
read file, the Mesh ("auto", "off" or "DPxMP") shards the index over
"mp" and the reads over "dp" (``parallel/mesh.py``), and rank 0 alone
writes matches.npz and the reports.
"""

from __future__ import annotations

import logging
import os
import shutil
import sys
import time
import uuid

import numpy as np

from ..config import Config
from ..io import reads as reads_io
from ..io import targets as targets_io

import torch
import torch.distributed as torch_dist

from ..device import rank_device
from ..parallel import dist as pdist
from ..parallel import mesh as pmesh
from . import pipeline, report
from .index import TargetIndex, build_target_index


def make_run_dirs(cfg: Config) -> str:
    run_id = str(uuid.uuid1())
    if cfg.TempDir:
        cfg.TempDir = os.path.join(cfg.TempDir, run_id)
    else:
        cfg.TempDir = os.path.join("muscato_tmp", run_id)
    os.makedirs(cfg.TempDir, exist_ok=True)
    if not cfg.LogDir:
        cfg.LogDir = "muscato_logs"
    cfg.LogDir = os.path.join(cfg.LogDir, run_id)
    os.makedirs(cfg.LogDir, exist_ok=True)
    return run_id


def _setup_logging(cfg: Config) -> logging.Logger:
    """One log file per stage plus the top-level muscato.log."""
    fmt = logging.Formatter("%(asctime)s %(name)s: %(message)s")

    def mk(name: str, filename: str, also=None) -> logging.Logger:
        lg = logging.getLogger(name)
        lg.setLevel(logging.INFO)
        for h in lg.handlers:
            h.close()
        lg.handlers.clear()
        lg.propagate = False
        fh = logging.FileHandler(os.path.join(cfg.LogDir, filename))
        fh.setFormatter(fmt)
        lg.addHandler(fh)
        if also is not None:
            lg.addHandler(also)
        return lg

    logger = mk("muscato", "muscato.log")
    main_fh = logger.handlers[0]
    mk("muscato.prep", "muscato_prep.log", also=main_fh)
    mk("muscato.index", "muscato_index.log", also=main_fh)
    mk("muscato.pipeline", "muscato_screen.log")
    mk("muscato.report", "muscato_report.log", also=main_fh)
    return logger


def run(cfg: Config, device="cuda") -> None:
    dev = rank_device(device)
    for label, path in (
        ("ReadFileName", cfg.ReadFileName),
        ("GeneFileName", cfg.GeneFileName),
        ("GeneIdFileName", cfg.GeneIdFileName),
    ):
        if not os.path.exists(path):
            sys.stderr.write(f"Cannot open {label} {path}\n")
            raise SystemExit(1)
    make_run_dirs(cfg)
    logger = _setup_logging(cfg)
    cfg.save(os.path.join(cfg.LogDir, "config.json"))

    own_group = False
    try:
        if not torch_dist.is_initialized() and (
            cfg.Coordinator or cfg.ProcessCount
            or int(os.environ.get("WORLD_SIZE", "1")) > 1
        ):
            pdist.initialize(
                coordinator_address=cfg.Coordinator or None,
                num_processes=cfg.ProcessCount or None,
                process_id=int(cfg.ProcessIndex) if cfg.ProcessIndex != "" else None,
                backend=os.environ.get("MUSCATO_DIST_BACKEND") or None,
                device=dev,
            )
            own_group = True
            logger.info(
                "process group: rank %d of %d (%s)", torch_dist.get_rank(),
                torch_dist.get_world_size(), torch_dist.get_backend(),
            )
        _run_stages(cfg, logger, dev)
    finally:
        if own_group:
            torch_dist.destroy_process_group()
        if not cfg.NoCleanTemp:
            shutil.rmtree(cfg.TempDir, ignore_errors=True)


def _choose_mesh(cfg: Config, n_bases: int, device):
    """The device mesh of this run, or None for the single-device engine.
    'auto' (the default) takes a mesh when the world has several
    processes: the fewest index shards that keep every shard under 1.5e9
    bases, and the other processes for read parallelism."""
    spec = (cfg.Mesh or "").strip().lower()
    if spec in ("off", "none", "single", "1x1"):
        return None
    world = torch_dist.get_world_size() if torch_dist.is_initialized() else 1
    if spec in ("", "auto"):
        if world <= 1:
            return None
        mp = 1
        while n_bases / mp > 1.5e9 and mp < world:
            mp *= 2
        dp = max(1, world // mp)
    else:
        try:
            dp_s, mp_s = spec.split("x")
            dp, mp = int(dp_s), int(mp_s)
        except ValueError:
            raise SystemExit(f"Mesh must be 'auto', 'off', or 'DPxMP'; got {cfg.Mesh!r}")
        if dp * mp == 1:
            return None
    return pmesh.make_mesh(dp, mp, device)


def _build_or_load_index(cfg: Config, ts, device) -> TargetIndex:
    ilog = logging.getLogger("muscato.index")
    if cfg.IndexFile and os.path.exists(cfg.IndexFile):
        t0 = time.time()
        index = TargetIndex.load(cfg.IndexFile, ts, cfg.WindowWidth, device)
        ilog.info(
            "loaded index %s: %d window keys in %.2fs",
            cfg.IndexFile, index.num_valid, time.time() - t0,
        )
        return index
    t0 = time.time()
    index = build_target_index(ts, cfg.WindowWidth, device)
    ilog.info(
        "built index: %d bases -> %d window keys in %.2fs",
        index.num_bases, index.num_valid, time.time() - t0,
    )
    if cfg.IndexFile:
        index.save(cfg.IndexFile)
        ilog.info("saved index to %s", cfg.IndexFile)
    return index


def _log_shard(shard, mesh, seconds: float) -> None:
    """Log this rank's shard build and, on a card, this process's peak
    reserved memory.  Under MUSCATO_STAGE_TIMES=1 also the card's used
    memory once every rank has built its shard (a barrier), which holds
    every rank's build when the ranks share the card."""
    index = shard.index
    mem = ""
    if index.device.type == "cuda":
        mem = f"; peak reserved {torch.cuda.max_memory_reserved(index.device) / 2**30:.2f} GiB"
        if os.environ.get("MUSCATO_STAGE_TIMES") == "1":
            mesh.agree_max(0)
            free, total = torch.cuda.mem_get_info(index.device)
            mem += (f", card used {(total - free) / 2**30:.2f} of {total / 2**30:.2f} GiB "
                    "after every rank's build")
    logging.getLogger("muscato.index").info(
        "mesh shard %d of %d (genes [%d,%d)): %d bases -> %d window keys built on %s "
        "in %.2fs%s", mesh.m, mesh.mp, *shard.genes, index.num_bases, index.num_valid,
        index.device, seconds, mem,
    )


def _run_stages(cfg: Config, logger: logging.Logger, device) -> None:
    t0 = time.time()
    plog = logging.getLogger("muscato.prep")
    rlog = logging.getLogger("muscato.report")

    sys.stderr.write("Preparing reads...\n")
    ts_prep = time.time()
    if torch_dist.is_initialized() and torch_dist.get_world_size() > 1:
        # Range-sharded prep: each process parses its byte range of the
        # read file and the unique sets merge on every process.
        rs = pdist.build_readset_multihost(
            cfg.ReadFileName, cfg.MinReadLength, cfg.MaxReadLength
        )
    elif cfg.PrepChunk:
        rs = reads_io.build_readset_chunked(
            cfg.ReadFileName, cfg.MinReadLength, cfg.MaxReadLength,
            chunk_reads=cfg.PrepChunk,
        )
    else:
        rs = reads_io.build_readset(
            cfg.ReadFileName, cfg.MinReadLength, cfg.MaxReadLength
        )
    plog.info(
        "prepared reads: %d total, %d unique in %.2fs",
        rs.num_total, rs.num_unique, time.time() - ts_prep,
    )
    with open(os.path.join(cfg.LogDir, "seqinfo.json"), "wt") as f:
        f.write('{"NumUnique":%d,"NumTotal":%d}\n' % (rs.num_unique, rs.num_total))
    reads_io.write_reads_sorted(rs, os.path.join(cfg.TempDir, "reads_sorted.txt.sz"))

    sys.stderr.write("Loading targets...\n")
    ts_tgt = time.time()
    ts = targets_io.load_targets(cfg.GeneFileName, cfg.GeneIdFileName)
    plog.info(
        "loaded %d target genes, %d bases in %.2fs",
        ts.num_genes, ts.size, time.time() - ts_tgt,
    )

    resume = os.path.join(cfg.ResumeDir, "matches.npz") if cfg.ResumeDir else ""
    if resume and os.path.exists(resume):
        # Stage-artifact resume: reuse a previous run's verified matches.
        sys.stderr.write(f"Resuming matches from {resume}...\n")
        d = np.load(resume)
        mr = pipeline.MatchResult(
            read_row=d["read_row"], gene=d["gene"],
            start=d["start"], nmiss=d["nmiss"],
        )
        logger.info("resumed %d matches from %s", len(mr.read_row), resume)
    else:
        sys.stderr.write("Screening and confirming...\n")

        def _match():
            mesh = _choose_mesh(cfg, ts.size, device)
            if mesh is not None:
                logger.info("mesh run: dp=%d mp=%d, rank %d", mesh.dp, mesh.mp, mesh.rank)
                t_build = time.time()
                shard = pmesh.shard_targets(ts, cfg.WindowWidth, mesh.mp, mesh.m, device)
                _log_shard(shard, mesh, time.time() - t_build)
                return pmesh.run_matching_sharded(cfg, rs, shard, mesh)
            index = _build_or_load_index(cfg, ts, device)
            return pipeline.run_matching_indexed(cfg, rs, index)

        if cfg.CPUProfile:
            # The reference's --CPUProfile profiles the screen; here the
            # matching stage runs under torch.profiler (CPU and, on a GPU,
            # CUDA activity) and the trace lands in LogDir.
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            trace = os.path.join(cfg.LogDir, "trace.json")
            with torch.profiler.profile(activities=acts) as prof:
                mr = _match()
            prof.export_chrome_trace(trace)
            logger.info("profiler trace written to %s", trace)
        else:
            mr = _match()

    if not pdist.is_primary():
        # Rank 0 ranks the gathered rows and writes the reports; this
        # process's MatchResult is empty by construction.
        logger.info("non-primary process: rank and report ran on rank 0")
        return

    logger.info("retained %d matches", len(mr.read_row))
    np.savez(
        os.path.join(cfg.TempDir, "matches.npz"),
        read_row=mr.read_row, gene=mr.gene, start=mr.start, nmiss=mr.nmiss,
    )

    sys.stderr.write("Writing results...\n")
    rlog_t = time.time()
    table = report.write_results(cfg.ResultsFileName, mr, rs, ts)
    report.write_nonmatch(cfg.ResultsFileName, mr, rs)
    report.write_readstats(cfg.ResultsFileName, table)
    report.write_genestats(cfg.ResultsFileName, table)
    rlog.info(
        "wrote %d result rows (+nonmatch/readstats/genestats) in %.2fs",
        table.nrows, time.time() - rlog_t,
    )
    logger.info("done in %.2fs", time.time() - t0)
