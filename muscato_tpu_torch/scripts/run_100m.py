"""Reference-scale single-host run (twin of the JAX package's
``scripts/run_100m.py``): 100M reads through the full ``muscato_torch``
driver against a 100M-base target set.

One run composes every scale feature of the driver: the disk-streamed
gendat (``gendat.generate_big``; ``gen_parallel`` writes the same genes
faster), the chunked read prep (PrepChunk), the index cached in an
IndexFile, read batches of 2**23 streamed through the device, and the
vectorised report.  It records each stage's wall and the driver process's
peak anonymous RSS (RssAnon: ru_maxrss also counts file-backed memmap
pages that an idle machine never evicts).  The driver runs with
MUSCATO_STAGE_TIMES=1, so its screen log (LogDir/<run id>/
muscato_screen.log) holds each batch's stage times.

Usage:
  python -u -m muscato_tpu_torch.scripts.run_100m gen  [dir]   # host only: write the data
  python -u -m muscato_tpu_torch.scripts.run_100m run  [dir] [--device cuda|cpu]
  python -u -m muscato_tpu_torch.scripts.run_100m both [dir] [--device cuda|cpu]

The default dir is ./r100m; N_READS in the environment sets the read
count (default 100,000,000).  ``--device`` defaults to cuda, which raises
when there is no card; cpu runs the kernels' plain twins.  Artifacts:
dir/run100m.json (the JAX script's keys), dir/driver.log (the driver's
output), dir/logs/<run id>/ (its logs).  The exit code is non-zero when
the driver's is.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

from .gen_parallel import _PKG_ROOT, DEFAULT_DIR, SEED, WORKLOAD


def gen(d: str, n_reads: int) -> dict:
    from ..bench import gendat

    t0 = time.time()
    print(gendat.generate_big(
        n_reads, WORKLOAD["read_len"], WORKLOAD["num_gene"], WORKLOAD["gene_len"],
        out_dir=d, seed=SEED, chunk=10_000_000, hit_frac=WORKLOAD["hit_frac"],
        sub_rate=WORKLOAD["sub_rate"]), flush=True)
    dt = time.time() - t0
    sz = os.path.getsize(os.path.join(d, "reads.fastq"))
    return {"gen_s": round(dt, 1), "fastq_bytes": sz}


def _anon_kb(pid: int) -> int:
    """The process's resident anonymous memory in kB: RssAnon of its
    status, or, where the kernel's status has no such line, the sum of
    Anonymous over its smaps (the same pages)."""
    with open(f"/proc/{pid}/status") as f:
        for ln in f:
            if ln.startswith("RssAnon:"):
                return int(ln.split()[1])
    total = 0
    with open(f"/proc/{pid}/smaps") as f:
        for ln in f:
            if ln.startswith("Anonymous:"):
                total += int(ln.split()[1])
    return total


def _watch_rss(pid: int, out: dict, stop: threading.Event):
    peak = 0
    while not stop.is_set():
        try:
            peak = max(peak, _anon_kb(pid))
        except OSError:
            break
        stop.wait(0.5)
    out["peak_anon_rss_mb"] = peak // 1024


def _prepared_fresh(src: str, outs) -> bool:
    """Whether the prepared target files ``outs`` may be reused: both exist,
    neither is empty, and both are newer than the raw gene file ``src``
    (an interrupted prep leaves one of them missing, empty or stale)."""
    src_t = os.stat(src).st_mtime_ns
    for p in outs:
        try:
            st = os.stat(p)
        except FileNotFoundError:
            return False
        if st.st_size == 0 or st.st_mtime_ns <= src_t:
            return False
    return True


def run(d: str, n_reads: int, device: str) -> dict:
    from ..io import targets

    cfgp = os.path.join(d, "config.json")
    cfg = {
        "ReadFileName": os.path.join(d, "reads.fastq"),
        "GeneFileName": os.path.join(d, "musc_genes.txt.sz"),
        "GeneIdFileName": os.path.join(d, "musc_ids_genes.txt.sz"),
        "ResultsFileName": os.path.join(d, "results.txt"),
        "Windows": [10, 30, 50, 70],
        "WindowWidth": 20,
        "PMatch": 0.96,
        "MinDinuc": 3,
        "MMTol": 2,
        "MaxReadLength": 200,
        "MatchMode": "best",
        "MaxMatches": 1000000,
        "ReadBatch": 1 << 23,
        "PrepChunk": 4000000,
        "IndexFile": os.path.join(d, "index_w20.npz"),
        "TempDir": os.path.join(d, "tmp"),
        "LogDir": os.path.join(d, "logs"),
    }
    rec: dict = {}
    t0 = time.time()
    src = os.path.join(d, "genes.txt.sz")
    if _prepared_fresh(src, targets.prepared_names(src)):
        rec["prep_targets_s"] = "cached"
    else:
        print(targets.prep_targets(src), flush=True)
        rec["prep_targets_s"] = round(time.time() - t0, 1)
    with open(cfgp, "w") as f:
        json.dump(cfg, f)

    env = dict(os.environ, PYTHONUNBUFFERED="1", MUSCATO_STAGE_TIMES="1",
               PYTHONPATH=os.pathsep.join(
                   p for p in (_PKG_ROOT, os.environ.get("PYTHONPATH")) if p))
    t0 = time.time()
    with open(os.path.join(d, "driver.log"), "wb") as log:
        p = subprocess.Popen(
            [sys.executable, "-u", "-c",
             "from muscato_tpu_torch import cli;"
             f"cli.main_muscato(['-ConfigFileName={cfgp}', '-device={device}'])"],
            env=env, stdout=log, stderr=subprocess.STDOUT,
        )
        stop = threading.Event()
        t = threading.Thread(target=_watch_rss, args=(p.pid, rec, stop))
        t.start()
        rcode = p.wait()
        stop.set()
        t.join()
    rec["driver_s"] = round(time.time() - t0, 1)
    rec["driver_exit"] = rcode
    rec["reads_per_sec_end_to_end"] = round(n_reads / rec["driver_s"], 1)
    pth = os.path.join(d, "results.txt")
    if os.path.exists(pth):
        with open(pth, "rb") as f:
            rec["result_rows"] = sum(1 for _ in f)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="run_100m")
    ap.add_argument("mode", nargs="?", default="both", choices=("gen", "run", "both"))
    ap.add_argument("dir", nargs="?", default=DEFAULT_DIR)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, where the kernels' plain twins run")
    ns = ap.parse_args(argv)
    n_reads = int(os.environ.get("N_READS", "100000000"))
    # Absolute, so that the driver's config names the same files wherever
    # it runs from.
    d = os.path.abspath(ns.dir)
    if ns.mode in ("run", "both"):
        from ..device import resolve_device

        resolve_device(ns.device)  # raises when a card is asked for and absent
    os.makedirs(d, exist_ok=True)
    outp = os.path.join(d, "run100m.json")
    rec = {}
    if os.path.exists(outp):
        with open(outp) as f:
            rec = json.load(f)
    rec["n_reads"] = n_reads
    rc = 0
    if ns.mode in ("gen", "both"):
        rec.update(gen(d, n_reads))
        with open(outp, "w") as f:
            json.dump(rec, f, indent=1)
    if ns.mode in ("run", "both"):
        rec.update(run(d, n_reads, ns.device))
        with open(outp, "w") as f:
            json.dump(rec, f, indent=1)
        rc = 1 if rec["driver_exit"] else 0
    print(json.dumps(rec, indent=1))
    return rc


if __name__ == "__main__":
    sys.exit(main())
