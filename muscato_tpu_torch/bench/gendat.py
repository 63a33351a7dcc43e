"""Synthetic benchmark data generator.

Replicates the semantics of muscato_gendat
(/root/reference/cmd/muscato_gendat/main.go): NumRead random reads of
ReadLen; in the first half of the NumGene genes, gene i carries an exact
copy of read i%10 starting at offset i%10, the rest random; the second half
is fully random.  Outputs reads.fastq (name lines "read_<i>", quality
'!'*len) and genes.txt.sz ("gene_<i>\\tseq" text, snappy framed).

The RNG is numpy (seeded) rather than Go's math/rand; the workload shape —
not the exact bytes — is the contract here.
"""

from __future__ import annotations

import os

import numpy as np

from ..io import sz

_BASES = np.frombuffer(b"ATGC", dtype=np.uint8)


def _name_blob(prefix: bytes, n: int, start: int = 0):
    """(blob, starts, lens) for prefix+decimal names start..start+n-1
    (vectorized)."""
    from ..io.blob import ranged_copy

    digits = np.arange(start, start + n).astype("S20")
    dl = np.char.str_len(digits).astype(np.int64)
    lens = dl + len(prefix)
    ends = np.cumsum(lens)
    starts = ends - lens
    blob = np.zeros(int(ends[-1]) if n else 0, np.uint8)
    pre = np.frombuffer(prefix, np.uint8)
    for k, ch in enumerate(pre):
        blob[starts + k] = ch
    dbuf = np.frombuffer(digits.tobytes(), np.uint8)
    ranged_copy(blob, starts + len(prefix), dbuf,
                np.arange(n, dtype=np.int64) * 20, dl)
    return blob, starts, lens


def _fastq_blob(read_mat: np.ndarray, name_start: int) -> np.ndarray:
    """FASTQ records for read_mat rows, names read_<name_start+i>, as one
    byte blob (record = name \\n seq \\n + \\n qual \\n)."""
    from ..io.blob import ranged_copy

    num_read, read_len = read_mat.shape
    nblob, nstarts, nlens = _name_blob(b"read_", num_read, name_start)
    rec_len = nlens + 1 + read_len + 3 + read_len + 1
    rec_end = np.cumsum(rec_len)
    rec_start = rec_end - rec_len
    blob = np.zeros(int(rec_end[-1]), np.uint8)
    ranged_copy(blob, rec_start, nblob, nstarts, nlens)
    at = rec_start + nlens
    blob[at] = ord("\n")
    seq_lens = np.full(num_read, read_len, np.int64)
    ranged_copy(blob, at + 1, read_mat.reshape(-1),
                np.arange(num_read, dtype=np.int64) * read_len, seq_lens)
    at = at + 1 + read_len
    blob[at] = ord("\n")
    blob[at + 1] = ord("+")
    blob[at + 2] = ord("\n")
    # constant '!' qualities via a ranged copy from one constant row
    # (flat-index expansion cost ~20s at 10M reads; see report.py)
    qual = np.full(read_len, ord("!"), np.uint8)
    ranged_copy(blob, at + 3, qual, np.zeros(num_read, np.int64), seq_lens)
    blob[at + 3 + read_len] = ord("\n")
    return blob


def generate(
    num_read: int,
    read_len: int,
    num_gene: int,
    gene_len: int,
    out_dir: str = ".",
    seed: int = 0,
) -> tuple[str, str]:
    if num_read < 10:
        raise ValueError("num_read must be at least 10")
    rng = np.random.default_rng(seed)

    read_mat = _BASES[rng.integers(0, 4, size=(num_read, read_len))]
    reads_path = os.path.join(out_dir, "reads.fastq")
    with open(reads_path, "wb") as f:
        f.write(_fastq_blob(read_mat, 0).tobytes())

    genes = _BASES[rng.integers(0, 4, size=(num_gene, gene_len))]
    half = num_gene // 2
    planted = read_mat[:10]
    for i in range(half):
        j = i % 10
        end = min(gene_len, j + read_len)
        genes[i, j:end] = planted[j][: end - j]
    genes_path = _genes_file(genes, out_dir)
    return reads_path, genes_path


def _genes_file(genes: np.ndarray, out_dir: str) -> str:
    """Write a (G, L) gene code matrix as gene_<i>\\tseq framed-snappy."""
    from ..io.blob import ranged_copy

    num_gene, gene_len = genes.shape
    genes_path = os.path.join(out_dir, "genes.txt.sz")
    gblob, gstarts, glens = _name_blob(b"gene_", num_gene)
    row_len = glens + 1 + gene_len + 1
    row_end = np.cumsum(row_len)
    row_start = row_end - row_len
    out = np.zeros(int(row_end[-1]), np.uint8)
    ranged_copy(out, row_start, gblob, gstarts, glens)
    out[row_start + glens] = ord("\t")
    ranged_copy(out, row_start + glens + 1, genes.reshape(-1),
                np.arange(num_gene, dtype=np.int64) * gene_len,
                np.full(num_gene, gene_len, np.int64))
    out[row_end - 1] = ord("\n")
    sz.write_bytes(genes_path, out.tobytes())
    return genes_path


def generate_big(
    num_read: int,
    read_len: int,
    num_gene: int,
    gene_len: int,
    out_dir: str = ".",
    seed: int = 0,
    chunk: int = 10_000_000,
    hit_frac: float = 0.5,
    sub_rate: float = 0.02,
) -> tuple[str, str]:
    """Disk-streamed gendat for reference-scale runs (100M+ reads).

    The fastq is written in `chunk`-read slices (unique names across the
    whole file), so peak host memory is O(chunk) instead of O(num_read) —
    a 100M-read fastq is ~22GB, which generate() would otherwise hold in
    RAM twice.  `hit_frac` of the reads are sampled from the genes with
    `sub_rate` substitutions (the realistic-density convention of
    generate_arrays_realistic); plain gendat reads are random and nearly
    all miss, which understates the verify stage at scale.  Gene file
    semantics match generate() minus the 10 planted prefix reads (the
    sampled reads provide hits)."""
    rng = np.random.default_rng(seed)
    genes = _BASES[rng.integers(0, 4, size=(num_gene, gene_len))]
    genes_path = _genes_file(genes, out_dir)

    reads_path = os.path.join(out_dir, "reads.fastq")
    max_off = max(gene_len - read_len, 1)
    with open(reads_path, "wb") as f:
        for c0 in range(0, num_read, chunk):
            n = min(chunk, num_read - c0)
            nhit = int(n * hit_frac)
            g = rng.integers(0, num_gene, nhit).astype(np.int32)
            o = rng.integers(0, max_off, nhit).astype(np.int32)
            cols = o[:, None] + np.arange(read_len, dtype=np.int32)[None, :]
            mat = np.empty((n, read_len), np.uint8)
            mat[:nhit] = genes[g[:, None], np.minimum(cols, gene_len - 1)]
            sub = rng.random((nhit, read_len)) < sub_rate
            mat[:nhit][sub] = _BASES[
                rng.integers(0, 4, int(sub.sum()))
            ]
            mat[nhit:] = _BASES[rng.integers(0, 4, (n - nhit, read_len))]
            f.write(_fastq_blob(mat, c0).tobytes())
    return reads_path, genes_path


def generate_arrays_realistic(
    num_read: int,
    read_len: int,
    num_gene: int,
    gene_len: int,
    seed: int = 0,
    sub_rate: float = 0.02,
    frac_random: float = 0.1,
):
    """Realistic benchmark workload: reads are *sampled from the genes*
    with random substitutions (plus a fraction of pure-random nonmatchers),
    mirroring the intent of the reference's bigtest
    (/root/reference/tests/bigtest/test.sh) and of real resequencing data.
    Unlike generate_arrays (where ~all probes miss), this loads the
    expansion and verify stages with realistic hit density.
    """
    from ..io.reads import ReadSet
    from ..io.seqcodec import _B2C
    from ..io.targets import TargetSet

    rng = np.random.default_rng(seed)
    genes = rng.integers(0, 4, size=(num_gene, gene_len), dtype=np.uint8)
    flat = genes.reshape(-1)

    g = rng.integers(0, num_gene, num_read)
    off = rng.integers(0, gene_len - read_len, num_read)
    start = g.astype(np.int64) * gene_len + off
    codes = flat[start[:, None] + np.arange(read_len, dtype=np.int64)[None, :]]
    # substitutions
    mut = rng.random((num_read, read_len)) < sub_rate
    codes = np.where(
        mut, rng.integers(0, 4, (num_read, read_len), dtype=np.uint8), codes
    )
    # pure-random nonmatchers
    nrand = int(num_read * frac_random)
    if nrand:
        codes[:nrand] = rng.integers(0, 4, (nrand, read_len), dtype=np.uint8)

    # dedup like prep does (void-row sort over the code matrix)
    view = np.ascontiguousarray(codes).view(f"V{read_len}").ravel()
    uniq, counts = np.unique(view, return_counts=True)
    ucodes = np.frombuffer(uniq.tobytes(), dtype=np.uint8).reshape(-1, read_len)
    rs = ReadSet(
        codes=ucodes,
        lengths=np.full(len(uniq), read_len, np.int32),
        counts=counts.astype(np.int64),
        names=[b"read_u%d" % i for i in range(len(uniq))],
        num_total=num_read,
    )
    gene_start = np.arange(num_gene + 1, dtype=np.int64) * gene_len
    ts = TargetSet(
        tcat=flat,
        gene_start=gene_start,
        names=[b"gene_%d" % i for i in range(num_gene)],
        lengths=np.diff(gene_start),
    )
    return rs, ts


def generate_arrays(
    num_read: int,
    read_len: int,
    num_gene: int,
    gene_len: int,
    seed: int = 0,
):
    """In-memory variant for benchmarking: returns (ReadSet, TargetSet)
    without touching disk."""
    from ..io.reads import ReadSet
    from ..io.seqcodec import _B2C
    from ..io.targets import TargetSet

    rng = np.random.default_rng(seed)
    read_bytes = _BASES[rng.integers(0, 4, size=(num_read, read_len))]
    codes = _B2C[read_bytes]

    # Dedup like prep does (byte sort over fixed-width rows).
    view = read_bytes.view([("s", f"S{read_len}")]).ravel()
    uniq, inv, counts = np.unique(view, return_inverse=True, return_counts=True)
    ucodes = _B2C[np.frombuffer(uniq.tobytes(), dtype=np.uint8).reshape(-1, read_len)]
    rs = ReadSet(
        codes=ucodes,
        lengths=np.full(len(uniq), read_len, np.int32),
        counts=counts.astype(np.int64),
        names=[b"read_u%d" % i for i in range(len(uniq))],
        seqs=[bytes(u[0]) for u in uniq],
        num_total=num_read,
    )

    genes = _B2C[_BASES[rng.integers(0, 4, size=(num_gene, gene_len))]]
    half = num_gene // 2
    for i in range(min(half, 10 * ((half + 9) // 10))):
        if i >= half:
            break
        j = i % 10
        end = min(gene_len, j + read_len)
        genes[i, j:end] = codes[j][: end - j]
    gene_start = np.arange(num_gene + 1, dtype=np.int64) * gene_len
    ts = TargetSet(
        tcat=genes.reshape(-1),
        gene_start=gene_start,
        names=[b"gene_%d" % i for i in range(num_gene)],
        lengths=np.diff(gene_start),
    )
    return rs, ts
