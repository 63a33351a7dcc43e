"""Benchmark harness of the port: reads/s on the matching core (twin of
``muscato_tpu/bench/runner.py``).

    python -m muscato_tpu_torch.bench.runner [--Workload big|small|both]
        [--NumRead N] [--ReadBatch N] [--Repeats N] [--device cuda|cpu]

prints one JSON line: ``metric`` (``reads_per_sec_chip`` on a CUDA
device, ``reads_per_sec_cpu`` with ``--device cpu``), ``value``, ``unit``,
``vs_baseline`` (against 10M reads/s) and ``detail``.  Two workloads:

  big    reads x 100 bp sampled (with substitutions) from 100,000 genes x
         1,000 bp: a 100M-base index with realistic hit density; the
         headline.
  small  random reads against 2,000 genes x 1,000 bp; probes mostly miss,
         so it measures window extraction and probe overhead.

The timed region is ``run_matching_indexed`` against a prebuilt index with
the reads already on the device (``preload_device_batch``): probe, expand,
verify, rank and the fetch of the retained rows.  The index build and one
run that includes the read upload are reported beside it.  Asked for
``cuda`` without a CUDA device it raises: nothing falls back to the CPU.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from dataclasses import dataclass

import torch

from ..config import Config
from ..device import resolve_device
from ..engine import pipeline
from ..engine.index import build_target_index
from . import gendat

NORTH_STAR = 10_000_000.0


@dataclass
class BenchResult:
    reads_per_sec: float
    unique_reads: int
    total_reads: int
    num_genes: int
    gene_bases: int
    index_build_s: float
    match_s: float
    matches: int
    with_transfers_s: float = 0.0
    result_fetch_s: float = 0.0
    result_fetch_bytes: int = 0
    end_to_end_s: float = 0.0
    index_build_detail: dict | None = None
    stage_times: dict | None = None
    probe_kind: str | None = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _subset(rs, shift: int, n: int):
    """A shifted n-read window of the pool: each timing repetition sees
    different reads."""
    from ..io.reads import ReadSet

    nu = rs.num_unique
    lo = min(shift, max(nu - n, 0))
    return ReadSet(
        codes=rs.codes[lo : lo + n], lengths=rs.lengths[lo : lo + n],
        counts=rs.counts[lo : lo + n],
        name_blob=rs.name_blob, name_off=rs.name_off[lo : lo + n + 1],
        num_total=n,
    )


def _bench_one(cfg: Config, rs, ts, num_read: int, repeats: int,
               device="cuda") -> BenchResult:
    device = resolve_device(device)
    t0 = time.perf_counter()
    index = build_target_index(ts, cfg.WindowWidth, device)
    index_build_s = time.perf_counter() - t0
    index_build_detail = index.build_timings

    n = rs.num_unique
    # Warm-up on a subset none of the repetitions reuses.
    warm = _subset(rs, repeats, n - repeats)
    pipeline.run_matching_indexed(cfg, warm, index)

    # Timed repetitions: the reads are staged on the device beforehand, so
    # the timed region is device compute and the result fetch.
    subs = [_subset(rs, rep, n - repeats) for rep in range(repeats)]
    for sub in subs:
        pipeline.preload_device_batch(cfg, sub, device)
    best = float("inf")
    best_e2e = float("inf")
    fetch_s = 0.0
    fetch_bytes = 0
    matches = 0
    stage_times = None
    probe_kind = None
    for sub in subs:
        tm: dict = {}
        _sync(device)
        t0 = time.perf_counter()
        mr = pipeline.run_matching_indexed(cfg, sub, index, timings=tm)
        _sync(device)
        dt = time.perf_counter() - t0
        # The headline is the batch loop (synchronised per batch by its
        # count fetches); the bulk row fetch is reported beside it.
        if tm["device_s"] < best:
            best = tm["device_s"]
            fetch_s = tm["fetch_s"]
            fetch_bytes = tm["fetch_bytes"]
            stage_times = tm["stages"]
            probe_kind = tm["probe_kind"]
        best_e2e = min(best_e2e, dt)
        matches = len(mr.read_row)

    # One unstaged run: includes the host-to-device read upload.
    sub = _subset(rs, repeats + 1, n - repeats - 1)
    _sync(device)
    t0 = time.perf_counter()
    pipeline.run_matching_indexed(cfg, sub, index)
    _sync(device)
    with_transfers = time.perf_counter() - t0

    return BenchResult(
        reads_per_sec=num_read / best,
        unique_reads=rs.num_unique,
        total_reads=num_read,
        num_genes=ts.num_genes,
        gene_bases=int(ts.gene_start[-1]),
        index_build_s=index_build_s,
        match_s=best,
        matches=matches,
        with_transfers_s=with_transfers,
        result_fetch_s=fetch_s,
        result_fetch_bytes=fetch_bytes,
        end_to_end_s=best_e2e,
        index_build_detail=index_build_detail,
        stage_times=stage_times,
        probe_kind=probe_kind,
    )


def run_bench_big(
    num_read: int = 4_000_000,
    read_len: int = 100,
    num_gene: int = 100_000,
    gene_len: int = 1_000,
    windows=(10, 30, 50, 70),
    window_width: int = 20,
    pmatch: float = 0.96,
    repeats: int = 3,
    seed: int = 0,
    read_batch: int = 0,
    device="cuda",
) -> BenchResult:
    cfg = Config(
        Windows=list(windows), WindowWidth=window_width, PMatch=pmatch,
        MinDinuc=3, MaxReadLength=read_len * 2, MMTol=2,
        MaxMatches=10**6, MatchMode="best",
        ReadBatch=read_batch,
    )
    rs, ts = gendat.generate_arrays_realistic(
        num_read, read_len, num_gene, gene_len, seed
    )
    return _bench_one(cfg, rs, ts, num_read, repeats, device)


def run_bench(
    num_read: int = 4_000_000,
    read_len: int = 100,
    num_gene: int = 2_000,
    gene_len: int = 1_000,
    windows=(10, 30, 50, 70),
    window_width: int = 20,
    pmatch: float = 0.96,
    repeats: int = 3,
    seed: int = 0,
    device="cuda",
) -> BenchResult:
    cfg = Config(
        Windows=list(windows), WindowWidth=window_width, PMatch=pmatch,
        MinDinuc=3, MaxReadLength=read_len * 2, MMTol=2,
        MaxMatches=10**6, MatchMode="best",
    )
    rs, ts = gendat.generate_arrays(num_read, read_len, num_gene, gene_len, seed)
    return _bench_one(cfg, rs, ts, num_read, repeats, device)


def _detail(r: BenchResult) -> dict:
    d = {
        "match_device_s": round(r.match_s, 4),
        "result_fetch_s": round(r.result_fetch_s, 4),
        "result_fetch_bytes": r.result_fetch_bytes,
        "end_to_end_s": round(r.end_to_end_s, 4),
        "with_transfers_s": round(r.with_transfers_s, 4),
        "index_build_s": round(r.index_build_s, 4),
        "unique_reads": r.unique_reads,
        "gene_bases": r.gene_bases,
        "matches": r.matches,
        "reads_per_sec": round(r.reads_per_sec, 1),
        "probe_kind": r.probe_kind,
    }
    if r.index_build_detail:
        d["index_build_detail"] = r.index_build_detail
    if r.stage_times:
        d["stage_times"] = r.stage_times
    return d


def device_detail(device: torch.device) -> dict:
    """The device's name and, for a CUDA device, its power limit as
    nvidia-smi reports them."""
    if device.type != "cuda":
        return {"device": "cpu", "power_limit": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={device.index or 0}"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    limit = smi.rpartition(",")[2].strip() if smi else None
    return {"device": torch.cuda.get_device_name(device), "power_limit": limit}


def main(argv=None) -> int:
    import argparse
    import logging

    from ..io import native

    p = argparse.ArgumentParser()
    p.add_argument("--Workload", choices=("big", "small", "both"), default="both")
    p.add_argument("--NumRead", type=int, default=8_000_000)
    p.add_argument("--ReadLen", type=int, default=100)
    p.add_argument("--NumGene", type=int, default=0)  # 0 = workload default
    p.add_argument("--GeneLen", type=int, default=1_000)
    p.add_argument("--Repeats", type=int, default=3)
    p.add_argument("--ReadBatch", type=int, default=0,
                   help="device read-batch size for the big workload "
                        "(0 = 1 << 23)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu, where the kernels' plain "
                        "twins run")
    ns = p.parse_args(argv)
    device = resolve_device(ns.device)
    native.ensure_built()  # fast index sort; graceful fallback if no g++
    if os.environ.get("MUSCATO_BENCH_LOG", "1") != "0":
        logging.basicConfig(level=logging.INFO,
                            format="%(asctime)s %(name)s %(message)s")

    detail = {}
    headline = None
    if ns.Workload in ("big", "both"):
        r = run_bench_big(
            num_read=ns.NumRead, read_len=ns.ReadLen,
            num_gene=ns.NumGene or 100_000, gene_len=ns.GeneLen,
            repeats=ns.Repeats, read_batch=ns.ReadBatch or (1 << 23),
            device=device,
        )
        headline = r
        detail["big"] = _detail(r)
    if ns.Workload in ("small", "both"):
        r = run_bench(
            num_read=min(ns.NumRead, 4_000_000), read_len=ns.ReadLen,
            num_gene=ns.NumGene or 2_000, gene_len=ns.GeneLen,
            repeats=ns.Repeats, device=device,
        )
        if headline is None:
            headline = r
        detail["small"] = _detail(r)
    detail["flags"] = pipeline.switches()
    detail.update(device_detail(device))
    print(json.dumps({
        "metric": "reads_per_sec_chip" if device.type == "cuda" else "reads_per_sec_cpu",
        "value": round(headline.reads_per_sec, 1),
        "unit": "reads/s",
        "vs_baseline": round(headline.reads_per_sec / NORTH_STAR, 4),
        "detail": detail,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
