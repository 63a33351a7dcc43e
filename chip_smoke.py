#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (muscato_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the four CUDA kernels from
muscato_tpu_torch/csrc with nvcc, then:

  1. prints the card (nvidia-smi name and power limit), torch and CUDA
     versions and the kernel build time;
  2. runs each kernel against its plain PyTorch twin on the card at the
     flagship workload's main-path shapes (98.1M index keys, 16.8M
     queries, ~10M pair lanes, a (2**20, 22) row gather) with duplicate
     runs, 0xFFFFFFFF keys, dead tails and piecewise step-backs; results
     must be exactly equal; prints each one's time and the twin's (CUDA
     events, median of 5);
  3. matches 100k reads of the flagship workload against the FULL
     100M-base index twice, on cuda and on cpu (the plain twins); the
     MatchResults must be identical;
  4. runs the flagship (4M reads x 100 bp against 100,000 genes x 1,000 bp,
     windows 10,30,50,70 at width 20) through run_matching_indexed with
     every launch counter set to 0 first, prints reads/s, matches, the
     pair total, per-stage CUDA-event times and peak device memory, and
     fails unless every kernel launched; then runs the muscato_torch
     entry point on gendat files prepared by prep_targets (same index
     size, fewer reads) and checks its four output files.

Every phase checks its results and any failure exits non-zero.  The line
before the last is a JSON object with each kernel's numbers; the last line
is {"ok": true, "device": {...}}.  Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

SEED = 0
NUM_READ, READ_LEN, NUM_GENE, GENE_LEN = 4_000_000, 100, 100_000, 1_000
WINDOWS, WIDTH = (10, 30, 50, 70), 20
BATCH = 1 << 22  # the engine's default read batch
PARITY_READS = 100_000
DRIVER_READS = 200_000  # the driver phase cuts the read count only

KERNELS = {
    # name: (source, the TPU kernel's function that reaches pl.pallas_call)
    "sorted_join": ("muscato_tpu_torch/csrc/join.cu", "muscato_tpu/ops/pallas_join.py:156"),
    "expand_owners": ("muscato_tpu_torch/csrc/expand.cu", "muscato_tpu/ops/pallas_expand.py:267"),
    "monotone_gather": ("muscato_tpu_torch/csrc/gather.cu", "muscato_tpu/ops/pallas_gather.py:121"),
    "monotone_gather_rows": ("muscato_tpu_torch/csrc/gather.cu", "muscato_tpu/ops/pallas_gather.py:276"),
}


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def config():
    from muscato_tpu.config import Config

    # bench/runner.py run_bench_big's configuration.
    return Config(
        Windows=list(WINDOWS), WindowWidth=WIDTH, PMatch=0.96, MinDinuc=3,
        MaxReadLength=2 * READ_LEN, MMTol=2, MaxMatches=10**6, MatchMode="best",
    )


def wrappers():
    from muscato_tpu_torch.ops import expand, gather, join

    return {
        "sorted_join": join.sorted_join,
        "expand_owners": expand.expand_owners,
        "monotone_gather": gather.monotone_gather,
        "monotone_gather_rows": gather.monotone_gather_rows,
    }


def time_ms(fn, reps: int = 5) -> float:
    """Median device time of fn in ms (CUDA events), after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _compare(name, got, exp) -> float:
    """Exact equality of the kernel's tensors with the twin's; returns the
    max absolute difference (0.0)."""
    import torch

    err = 0.0
    for g, e in zip(got, exp):
        check(g.shape == e.shape and g.dtype == e.dtype, f"{name}: shape/dtype")
        err = max(err, float((g.to(torch.int64) - e.to(torch.int64)).abs().max()))
    check(err == 0.0, f"{name}: kernel differs from its plain twin (max abs {err})")
    return err


def kernel_phase(dev) -> dict:
    """Each kernel against its twin at main-path shapes; returns
    {name: {max_abs_err, ms, plain_ms, shapes}}."""
    import torch

    from muscato_tpu_torch.engine.pipeline import _bucket_ceil
    from muscato_tpu_torch.ops import expand, gather, join

    g = torch.Generator(device=dev).manual_seed(SEED)

    def rand_u32(n):
        return torch.randint(0, 2**32, (n,), dtype=torch.int64, device=dev,
                             generator=g).to(torch.int32)

    out = {}
    # B1: the sorted index (V = genes x valid windows per gene) with
    # duplicate runs and 0xFFFFFFFF keys, against K x batch sorted queries.
    v = NUM_GENE * (GENE_LEN - WIDTH + 1)
    q = len(WINDOWS) * BATCH
    base = rand_u32(v // 2)
    ntop = 5000
    keys = torch.cat([base, base[: v // 4], base[: v - v // 2 - v // 4 - ntop],
                      torch.full((ntop,), -1, dtype=torch.int32, device=dev)])
    keys = join.flip(torch.sort(join.flip(keys)).values)
    hits = keys[torch.randint(0, v, (q // 2,), device=dev, generator=g)]
    qs = torch.cat([hits, rand_u32(q - q // 2 - 2),
                    torch.tensor([0, -1], dtype=torch.int32, device=dev)])
    qs = join.flip(torch.sort(join.flip(qs)).values)
    got = join.sorted_join(keys, qs)[:2]
    exp = join.sorted_join_torch(keys, qs)[:2]
    out["sorted_join"] = dict(
        max_abs_err=_compare("sorted_join", got, exp),
        ms=time_ms(lambda: join.sorted_join(keys, qs)),
        plain_ms=time_ms(lambda: join.sorted_join_torch(keys, qs)),
        shapes=f"skeys ({v},) qkeys ({q},)",
    )
    del got, exp, hits

    # B2: probe slots in lo order — a live prefix, then a dead tail —
    # owning ~10M pair lanes; the buffer has lanes past the total.
    m = q
    nlive = q // 4
    counts = torch.zeros(m, dtype=torch.int32, device=dev)
    counts[:nlive] = torch.randint(1, 5, (nlive,), dtype=torch.int32, device=dev,
                                   generator=g)
    oexcl = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    lo = torch.sort(torch.randint(0, v - 8, (m,), dtype=torch.int32, device=dev,
                                  generator=g)).values
    qid = torch.randperm(m, device=dev, generator=g).to(torch.int32)
    qid[nlive:] = -1
    total = int(counts.sum())
    pair_cap = _bucket_ceil(total)
    check(pair_cap > total, "B2 case needs lanes past the pair total")
    got = expand.expand_owners(oexcl, lo, qid, pair_cap=pair_cap)
    exp = expand.expand_owners_torch(oexcl, lo, qid, pair_cap=pair_cap)
    out["expand_owners"] = dict(
        max_abs_err=_compare("expand_owners", got, exp),
        ms=time_ms(lambda: expand.expand_owners(oexcl, lo, qid, pair_cap=pair_cap)),
        plain_ms=time_ms(lambda: expand.expand_owners_torch(oexcl, lo, qid, pair_cap=pair_cap)),
        shapes=f"slots ({m},) pair_cap {pair_cap} (total {total})",
    )

    # B3: the postings fetch spos[sidx] — piecewise nondecreasing (runs
    # re-expanded for same-key slots step back), clamped dead tail.
    spos = torch.randint(0, NUM_GENE * GENE_LEN, (v,), dtype=torch.int32,
                         device=dev, generator=g)
    sidx = got[1].clamp(0, v - 1)
    del got, exp, counts, oexcl, lo, qid
    got = gather.monotone_gather(spos, sidx)[:1]
    exp = gather.monotone_gather_torch(spos, sidx)[:1]
    out["monotone_gather"] = dict(
        max_abs_err=_compare("monotone_gather", got, exp),
        ms=time_ms(lambda: gather.monotone_gather(spos, sidx)),
        plain_ms=time_ms(lambda: gather.monotone_gather_torch(spos, sidx)),
        shapes=f"table ({v},) idx ({pair_cap},)",
    )
    del got, exp, spos, sidx

    # B4: the target-row fetch of one verify chunk: (T, 22) trows, a
    # nondecreasing row stream whose dead tail maps to the last row.
    nrows = (NUM_GENE * GENE_LEN - 1) // 64 + 1
    trows = torch.randint(0, 2**32, (nrows, 22), dtype=torch.int64, device=dev,
                          generator=g).to(torch.int32)
    vchunk = 1 << 20
    ridx = torch.sort(torch.randint(0, nrows, (vchunk,), dtype=torch.int32,
                                    device=dev, generator=g)).values
    ridx[-vchunk // 10:] = nrows - 1
    got = gather.monotone_gather_rows(trows, ridx)[:1]
    exp = gather.monotone_gather_rows_torch(trows, ridx)[:1]
    out["monotone_gather_rows"] = dict(
        max_abs_err=_compare("monotone_gather_rows", got, exp),
        ms=time_ms(lambda: gather.monotone_gather_rows(trows, ridx)),
        plain_ms=time_ms(lambda: gather.monotone_gather_rows_torch(trows, ridx)),
        shapes=f"table ({nrows}, 22) ridx ({vchunk},)",
    )
    for name, r in out.items():
        print(f"kernel {name}: exact vs twin; {r['ms']:.3f} ms "
              f"(plain twin {r['plain_ms']:.3f} ms) at {r['shapes']}", flush=True)
    return out


def same_result(a, b) -> bool:
    import numpy as np

    return all(
        np.array_equal(getattr(a, f), getattr(b, f))
        for f in ("read_row", "gene", "start", "nmiss")
    )


def check_result(mr, rs, ts, cfg) -> None:
    """Retained rows are in range, in canonical order, and within budget."""
    import numpy as np

    from muscato_tpu_torch.ops.verify import mismatch_budget_table

    n = len(mr.read_row)
    check(n > 0, "no matches")
    check(mr.read_row.min() >= 0 and mr.read_row.max() < rs.num_unique, "read rows")
    check(mr.gene.min() >= 0 and mr.gene.max() < ts.num_genes, "genes")
    glen = np.diff(np.asarray(ts.gene_start))[mr.gene]
    rlen = rs.lengths[mr.read_row]
    check((mr.start >= 0).all() and (mr.start + rlen <= glen).all(), "starts")
    budget = mismatch_budget_table(cfg.PMatch, cfg.MaxReadLength)
    check((mr.nmiss >= 0).all() and (mr.nmiss <= budget[rlen]).all(), "nmiss budget")
    key = mr.read_row.astype(np.int64) * ts.num_genes + mr.gene
    order_ok = (np.diff(key) > 0) | ((np.diff(key) == 0) & (np.diff(mr.start) > 0))
    check(order_ok.all(), "canonical (read, gene, start) order")


def cpu_copy(index):
    """The same TargetIndex with its tensors on the CPU."""
    import dataclasses

    return dataclasses.replace(
        index, tpacked=index.tpacked.cpu(), gene_start=index.gene_start.cpu(),
        skeys=index.skeys.cpu(), spos=index.spos.cpu(), _trows=None, _gblock=None,
    )


def match_phases(dev) -> dict:
    import torch

    from muscato_tpu.bench import gendat
    from muscato_tpu.io.reads import ReadSet
    from muscato_tpu_torch.engine import pipeline

    cfg = config()
    t0 = time.perf_counter()
    rs, ts = gendat.generate_arrays_realistic(
        NUM_READ, READ_LEN, NUM_GENE, GENE_LEN, SEED
    )
    print(f"workload: {rs.num_unique} unique of {NUM_READ} reads, "
          f"{ts.num_genes} genes, {int(ts.gene_start[-1])} bases "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)
    t0 = time.perf_counter()
    index = pipeline.build_target_index(ts, WIDTH, dev)
    print(f"index: {index.num_valid} window keys in "
          f"{time.perf_counter() - t0:.1f}s {index.build_timings}", flush=True)

    # Parity against the full index: cuda kernels vs cpu plain twins.
    n = PARITY_READS
    sub = ReadSet(codes=rs.codes[:n], lengths=rs.lengths[:n],
                  counts=rs.counts[:n], num_total=n)
    t0 = time.perf_counter()
    got = pipeline.run_matching_indexed(cfg, sub, index)
    t1 = time.perf_counter()
    exp = pipeline.run_matching_indexed(cfg, sub, cpu_copy(index))
    t2 = time.perf_counter()
    check(same_result(got, exp), "cuda and cpu MatchResults differ")
    check_result(got, sub, ts, cfg)
    print(f"parity: {n} reads vs the full index, {len(got.read_row)} matches "
          f"identical on cuda ({t1 - t0:.2f}s) and cpu ({t2 - t1:.2f}s)",
          flush=True)

    # The flagship through the main path: one warm-up run, then the
    # counted and timed run.
    pipeline.run_matching_indexed(cfg, rs, index)
    wr = wrappers()
    for fn in wr.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    timings = {}
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    mr = pipeline.run_matching_indexed(cfg, rs, index, timings=timings)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wr.items()}
    check(all(v > 0 for v in launches.values()), f"a kernel never launched: {launches}")
    check_result(mr, rs, ts, cfg)
    stages = timings["stages"]
    flag = dict(
        reads=NUM_READ, unique_reads=rs.num_unique, matches=len(mr.read_row),
        pairs=timings["pairs"], wall_s=wall, reads_per_s=NUM_READ / wall,
        stage_s=stages, stages_sum_s=sum(stages.values()),
        host_read_prep_s=timings["read_prep_s"], host_fetch_s=timings["fetch_s"],
        peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
        launches=launches,
    )
    print("flagship: " + json.dumps(flag), flush=True)
    del index, rs, ts
    return flag


def driver_phase(dev) -> None:
    """The muscato_torch entry point on gendat files (full index size,
    DRIVER_READS reads) prepared by prep_targets."""
    from muscato_tpu.bench import gendat
    from muscato_tpu.io import targets
    from muscato_tpu_torch import cli

    work = tempfile.mkdtemp(prefix="muscato_chip_smoke_")
    try:
        t0 = time.perf_counter()
        reads, genes = gendat.generate_big(
            DRIVER_READS, READ_LEN, NUM_GENE, GENE_LEN, out_dir=work, seed=SEED,
            hit_frac=0.9,
        )
        seq, ids = targets.prep_targets(genes, rev=False)
        cfg = config()
        cfg.ReadFileName, cfg.GeneFileName, cfg.GeneIdFileName = reads, seq, ids
        cfg.ResultsFileName = os.path.join(work, "results.txt")
        cfg.TempDir, cfg.LogDir = os.path.join(work, "tmp"), os.path.join(work, "logs")
        cfg_path = os.path.join(work, "config.json")
        cfg.save(cfg_path)
        t1 = time.perf_counter()
        rc = cli.main_muscato([f"-ConfigFileName={cfg_path}", f"-device={dev}"])
        t2 = time.perf_counter()
        check(rc == 0, f"muscato_torch exited {rc}")
        outs = {
            "results": cfg.ResultsFileName,
            "nonmatch": os.path.join(work, "results.nonmatch.txt.fastq"),
            "readstats": os.path.join(work, "results_readstats.txt"),
            "genestats": os.path.join(work, "results_genestats.txt"),
        }
        sizes = {k: os.path.getsize(p) for k, p in outs.items()}
        check(all(s > 0 for s in sizes.values()), f"empty output: {sizes}")
        with open(outs["results"], "rb") as f:
            nres = f.read().count(b"\n")
        check(nres > DRIVER_READS // 4, f"only {nres} result rows")
        print(f"driver: muscato_torch on {DRIVER_READS} reads (read count cut "
              f"from {NUM_READ}; index size, read length and windows uncut) x "
              f"{NUM_GENE} genes: {nres} result rows, files {sizes}; "
              f"data+prep {t1 - t0:.1f}s, run {t2 - t1:.1f}s", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(smi.stdout.strip(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)

    from muscato_tpu.io import native
    from muscato_tpu_torch.ops import _lib

    t0 = time.perf_counter()
    kern = _lib.kernels()
    print(f"kernels: built {kern.path} in {kern.build_s:.2f}s "
          f"(load {time.perf_counter() - t0:.2f}s)", flush=True)
    print(kern.log.strip(), flush=True)
    t0 = time.perf_counter()
    print(f"native host library: {native.ensure_built() is not None} "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)

    kres = kernel_phase(dev)
    flag = match_phases(dev)
    driver_phase(dev)

    line = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "launches": flag["launches"][name],
         "max_abs_err": kres[name]["max_abs_err"], "ms": kres[name]["ms"],
         "plain_ms": kres[name]["plain_ms"]}
        for name in KERNELS
    ]}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
