"""Parallel disk-streamed gendat for the 100M-read run (host only; twin of
the JAX package's ``scripts/gen_parallel.py``, byte for byte).

``gendat.generate_big`` is one sequential RNG stream; a 100M-read fastq
(about 21 GB) takes over an hour on one core.  This splits the read range
into chunks of ``GEN_CHUNK`` reads (default 10,000,000), gives each worker
process a contiguous range of chunks, seeds chunk i with
``default_rng((7, i))`` (the data is equally realistic, though not the
sequential stream's bytes), and joins the part files in order.  The genes
(and genes.txt.sz) are the same seed-7 draw as ``generate_big``'s, so the
hit density and the target set are unchanged.  The output is
byte-identical to the JAX script's for the same arguments.

Usage: python -u -m muscato_tpu_torch.scripts.gen_parallel [dir] [n_reads] [workers]
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import time

# The workload of the reference-scale run, used by the workers, by the
# genes file and by run_100m's gen: genes (count, bases each), read
# length, the share of reads sampled from the genes, and their
# substitution rate.
WORKLOAD = {"num_gene": 100_000, "gene_len": 1_000, "read_len": 100,
            "hit_frac": 0.5, "sub_rate": 0.02}
SEED = 7
DEFAULT_DIR = "r100m"
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _chunk() -> int:
    return int(os.environ.get("GEN_CHUNK", "10000000"))


def _genes():
    """The (num_gene, gene_len) uint8 gene bases: the seed-7 draw."""
    import numpy as np

    from ..bench import gendat

    rng0 = np.random.default_rng(SEED)
    return gendat._BASES[rng0.integers(0, 4, size=(WORKLOAD["num_gene"], WORKLOAD["gene_len"]))]


def worker(out_dir: str, w: int, c_lo: int, c_hi: int, n_reads: int) -> None:
    """Write chunks [c_lo, c_hi) of the reads to ``reads.part<w>``."""
    import numpy as np

    from ..bench import gendat

    gene_len, read_len = WORKLOAD["gene_len"], WORKLOAD["read_len"]
    chunk = _chunk()
    genes = _genes()
    max_off = max(gene_len - read_len, 1)
    part = os.path.join(out_dir, f"reads.part{w:02d}")
    with open(part + ".tmp", "wb") as f:
        for ci in range(c_lo, c_hi):
            c0 = ci * chunk
            n = min(chunk, n_reads - c0)
            if n <= 0:
                break
            rng = np.random.default_rng((SEED, ci))
            nhit = int(n * WORKLOAD["hit_frac"])
            g = rng.integers(0, WORKLOAD["num_gene"], nhit).astype(np.int32)
            o = rng.integers(0, max_off, nhit).astype(np.int32)
            cols = o[:, None] + np.arange(read_len, dtype=np.int32)[None, :]
            mat = np.empty((n, read_len), np.uint8)
            mat[:nhit] = genes[g[:, None], np.minimum(cols, gene_len - 1)]
            sub = rng.random((nhit, read_len)) < WORKLOAD["sub_rate"]
            mat[:nhit][sub] = gendat._BASES[rng.integers(0, 4, int(sub.sum()))]
            mat[nhit:] = gendat._BASES[rng.integers(0, 4, (n - nhit, read_len))]
            f.write(gendat._fastq_blob(mat, c0).tobytes())
            print(f"w{w} chunk {ci} done", flush=True)
    os.replace(part + ".tmp", part)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out_dir = argv[0] if len(argv) > 0 else DEFAULT_DIR
    n_reads = int(argv[1]) if len(argv) > 1 else 100_000_000
    nw = int(argv[2]) if len(argv) > 2 else 4
    if len(argv) > 3 and argv[3] == "--worker":
        worker(out_dir, int(argv[4]), int(argv[5]), int(argv[6]), n_reads)
        return 0

    os.makedirs(out_dir, exist_ok=True)
    chunk = _chunk()
    nchunks = (n_reads + chunk - 1) // chunk
    per = (nchunks + nw - 1) // nw
    t0 = time.time()

    if not os.path.exists(os.path.join(out_dir, "genes.txt.sz")):
        from ..bench import gendat

        gendat._genes_file(_genes(), out_dir)
        print("genes.txt.sz written", flush=True)

    # Each worker is this module in a child process; the package root goes
    # on its path so that it imports wherever the caller runs from.
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (_PKG_ROOT, os.environ.get("PYTHONPATH")) if p))
    procs = []
    for w in range(nw):
        c_lo, c_hi = w * per, min((w + 1) * per, nchunks)
        if c_lo >= c_hi:
            continue
        p = subprocess.Popen(
            [sys.executable, "-u", "-m", "muscato_tpu_torch.scripts.gen_parallel", out_dir,
             str(n_reads), str(nw), "--worker", str(w), str(c_lo), str(c_hi)],
            env=env)
        procs.append((w, p))
    rc = 0
    for w, p in procs:
        rc |= p.wait()
    if rc:
        print(f"worker failure rc={rc}", flush=True)
        return rc

    dst = os.path.join(out_dir, "reads.fastq")
    with open(dst + ".tmp", "wb") as out:
        for w, _ in procs:
            part = os.path.join(out_dir, f"reads.part{w:02d}")
            with open(part, "rb") as f:
                shutil.copyfileobj(f, out, 64 << 20)
            os.unlink(part)
    os.replace(dst + ".tmp", dst)
    sz = os.path.getsize(dst)
    print(f"done: {sz} bytes in {time.time()-t0:.0f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
