"""Top-level run driver of the ``muscato_torch`` entry point (port of the
single-device branch of ``muscato_tpu/engine/driver.py``).

The observable behavior is the JAX driver's: a uuid run id names
muscato_tmp/<uuid>/ and muscato_logs/<uuid>/, the merged config goes to
LogDir/config.json, per-stage log files and seqinfo.json land in LogDir,
reads_sorted.txt.sz and matches.npz go to TempDir (removed at exit unless
NoCleanTemp), and results.txt, the nonmatch fastq, readstats and genestats
are written byte for byte as the JAX package writes them.  The compute
stages run on the ``device`` given to ``run``.

Not ported yet (each raises NotImplementedError naming it): IndexFile,
ResumeDir, the device mesh (Mesh "DPxMP") and the multi-host runtime
(Coordinator / ProcessCount).
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

from ..device import resolve_device
from . import pipeline, report
from .index import build_target_index


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


def _check_ported(cfg: Config) -> None:
    if cfg.IndexFile:
        raise NotImplementedError("IndexFile is not ported to muscato_tpu_torch yet")
    if cfg.ResumeDir:
        raise NotImplementedError("ResumeDir is not ported to muscato_tpu_torch yet")
    if cfg.Coordinator or cfg.ProcessCount:
        raise NotImplementedError(
            "the multi-host runtime is not ported to muscato_tpu_torch yet"
        )
    spec = (cfg.Mesh or "").strip().lower()
    if spec not in ("", "auto", "off", "none", "single", "1x1"):
        raise NotImplementedError(
            f"the device mesh (Mesh={cfg.Mesh!r}) is not ported to "
            "muscato_tpu_torch yet"
        )


def run(cfg: Config, device="cuda") -> None:
    _check_ported(cfg)
    dev = resolve_device(device)
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

    try:
        _run_stages(cfg, logger, dev)
    finally:
        if not cfg.NoCleanTemp:
            shutil.rmtree(cfg.TempDir, ignore_errors=True)


def _run_stages(cfg: Config, logger: logging.Logger, device) -> None:
    t0 = time.time()
    plog = logging.getLogger("muscato.prep")
    rlog = logging.getLogger("muscato.report")
    ilog = logging.getLogger("muscato.index")

    sys.stderr.write("Preparing reads...\n")
    ts_prep = time.time()
    if cfg.PrepChunk:
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

    sys.stderr.write("Screening and confirming...\n")

    def _match():
        ti = time.time()
        index = build_target_index(ts, cfg.WindowWidth, device)
        ilog.info(
            "built index: %d bases -> %d window keys in %.2fs",
            index.num_bases, index.num_valid, time.time() - ti,
        )
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
