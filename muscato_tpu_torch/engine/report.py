"""Output emission: results.txt, nonmatch fastq, read/gene statistics.

This is the host-side tail of the pipeline, replacing the reference's
sortByGeneId | joinGeneNames | joinReadNames | nonmatch | readstats |
genestats stages (reference cmd/muscato/main.go:507-676, 981-1003,
94-150).  String formatting and ordering follow the reference contract
byte-for-byte:

  - results.txt rows are "readseq  targetsub  pos  nmiss  gene  genelen
    copies  names" (8 tab-separated columns, README.md:77-94), ordered like
    `LC_ALL=C sort -k1` over the pre-join 6-column lines — whole-line
    lexicographic byte order, so position "10" sorts before "9"
    (verified against tests/data/muscato/03/result_e.txt);
  - the nonmatch fastq lists every unique read sequence absent from the
    results, in read-sorted order, as "names#count / seq / + / '!'*len"
    (cmd/muscato_nonmatch/main.go:95-107) — with *exact* membership where
    the reference uses a Bloom filter that can silently drop reads
    (main.go:52-54; deliberate fidelity upgrade, SURVEY.md section 7.1);
  - <results>_readstats.<ext>: per distinct names-column value in results
    order, "readid<TAB>gene1;gene2;...;" — gene sets are emitted in sorted
    order where the reference iterates a Go map in random order
    (cmd/muscato_readstats/main.go:74-85; deterministic here);
  - <results>_genestats.<ext>: "gene<TAB>count<TAB>" per gene, grouped in
    the order of `sort -k5` over results (cmd/muscato_genestats/main.go:33-55).

The round-1 implementation formatted each row in a Python loop; at
"hundreds of millions of reads" scale that was the host-side tail wagging
the device dog.  Everything here is numpy blob assembly: each output
column is (byte source, starts, lengths), rows are materialized with one
vectorized ranged copy per column, and the C-locale whole-line sort runs
on a fixed-width NUL-padded view (numpy S-dtype comparison == C-locale
byte order for NUL-free text).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..io.blob import decode_rows_blob, gather_ranges as _gather_ranges, ranged_copy
from ..io.reads import ReadSet
from ..io.seqcodec import _C2B
from ..io.targets import TargetSet
from .pipeline import MatchResult


@dataclass
class Column:
    """A per-row byte field: row i is blob[starts[i] : starts[i]+lens[i]]."""

    blob: np.ndarray  # uint8
    starts: np.ndarray  # int64
    lens: np.ndarray  # int64

    def reorder(self, order: np.ndarray) -> "Column":
        return Column(self.blob, self.starts[order], self.lens[order])


def _int_column(vals: np.ndarray) -> Column:
    s = vals.astype("S20")
    lens = np.char.str_len(s).astype(np.int64)
    blob = np.frombuffer(s.tobytes(), np.uint8)
    starts = np.arange(len(vals), dtype=np.int64) * 20
    return Column(blob, starts, lens)


def _list_column(items, pick: np.ndarray) -> Column:
    """Column over a list of bytes, one row per pick[i]."""
    off = np.zeros(len(items) + 1, np.int64)
    off[1:] = np.cumsum([len(x) for x in items])
    blob = np.frombuffer(b"".join(items), np.uint8) if items else np.zeros(0, np.uint8)
    return Column(blob, off[:-1][pick], (off[1:] - off[:-1])[pick])


def _assemble(cols, sep: int, eol: int | None):
    """Join columns with `sep` between fields (and `eol` after the last);
    returns (blob, row_starts, row_lens)."""
    n = len(cols[0].lens)
    gaps = len(cols) - 1 + (1 if eol is not None else 0)
    row_len = sum(c.lens for c in cols) + gaps
    row_end = np.cumsum(row_len)
    row_start = row_end - row_len
    blob = np.zeros(int(row_end[-1]) if n else 0, np.uint8)
    at = row_start.copy()
    for i, c in enumerate(cols):
        ranged_copy(blob, at, c.blob, c.starts, c.lens)
        at = at + c.lens
        if i < len(cols) - 1:
            blob[at] = sep
            at = at + 1
    if eol is not None:
        blob[at] = eol
    return blob, row_start, row_len


def _fixed_view(cols, sep: int):
    """Rows joined with sep into a fixed-width NUL-padded (n,) S-array —
    numpy S comparison over it equals C-locale whole-line order."""
    n = len(cols[0].lens)
    row_len = sum(c.lens for c in cols) + (len(cols) - 1)
    w = int(row_len.max(initial=1))
    mat = np.zeros(n * w, np.uint8)
    at = np.arange(n, dtype=np.int64) * w
    for i, c in enumerate(cols):
        ranged_copy(mat, at, c.blob, c.starts, c.lens)
        at = at + c.lens
        if i < len(cols) - 1:
            mat[at] = sep
            at = at + 1
    return mat.reshape(n, w).view(f"S{w}").ravel()


@dataclass
class ResultsTable:
    """Per-row output fields of results.txt, already in final (C-locale
    whole-line) order."""

    rseq: Column
    tsub: Column
    pos: Column
    nmiss: Column
    gene: Column
    glen: Column
    copies: Column
    names: Column
    nrows: int

    def cols(self):
        return [self.rseq, self.tsub, self.pos, self.nmiss,
                self.gene, self.glen, self.copies, self.names]


def build_results(mr: MatchResult, rs: ReadSet, ts: TargetSet) -> ResultsTable:
    n = len(mr.read_row)
    r = mr.read_row.astype(np.int64)
    g = mr.gene.astype(np.int64)
    s = mr.start.astype(np.int64)
    rl = rs.lengths.astype(np.int64)[r]

    # read sequences: decode the matched rows into a compact blob
    starts_out = np.cumsum(rl, dtype=np.int64) - rl
    rseq_blob = np.zeros(int(rl.sum()), np.uint8)
    decode_rows_blob(rseq_blob, starts_out, rs.codes, rs.codes.shape[1], r, rl, _C2B)
    rseq = Column(rseq_blob, starts_out, rl)

    # target subsequences: ranged decode straight from the gene stream
    tcat = np.asarray(ts.tcat)
    gstart = np.asarray(ts.gene_start, dtype=np.int64)[g]
    tsub_starts = gstart + s
    tsub_blob = np.zeros(int(rl.sum()), np.uint8)
    decode_rows_blob(tsub_blob, starts_out, tcat, 1, tsub_starts, rl, _C2B)
    tsub = Column(tsub_blob, starts_out, rl)

    pos = _int_column(mr.start)
    nmiss = _int_column(mr.nmiss)
    gene = _list_column(ts.names, g)
    glen = _int_column(np.asarray(ts.lengths, dtype=np.int64)[g])
    copies = _int_column(rs.counts[mr.read_row])
    names = Column(rs.name_blob, rs.name_off[:-1][r], np.diff(rs.name_off)[r])

    # C-locale whole-line order of the six pre-join columns
    # (cmd/muscato/main.go:657-670 sorts before joining read names; the
    # join appends copies+names per read, preserving that order).
    prefix = _fixed_view([rseq, tsub, pos, nmiss, gene, glen], ord("\t"))
    order = np.argsort(prefix, kind="stable")

    t = ResultsTable(
        rseq=rseq.reorder(order), tsub=tsub.reorder(order),
        pos=pos.reorder(order), nmiss=nmiss.reorder(order),
        gene=gene.reorder(order), glen=glen.reorder(order),
        copies=copies.reorder(order), names=names.reorder(order),
        nrows=n,
    )
    return t


def write_results(path: str, mr: MatchResult, rs: ReadSet, ts: TargetSet) -> ResultsTable:
    t = build_results(mr, rs, ts)
    blob, _, _ = _assemble(t.cols(), ord("\t"), ord("\n"))
    with open(path, "wb") as f:
        blob.tofile(f)  # tobytes() would double peak RAM at 100M reads
    return t


def nonmatch_path(results_path: str) -> str:
    """Derive the nonmatch fastq name exactly like the reference
    (cmd/muscato_nonmatch/main.go:66-71): split the basename on '.',
    replace the last token with 'nonmatch', and append '<oldext>.fastq'."""
    d, b = os.path.split(results_path)
    c = b.split(".")
    last = c[-1]
    c[-1] = "nonmatch"
    c.append(last + ".fastq")
    return os.path.join(d, ".".join(c))


def write_nonmatch(results_path: str, mr: MatchResult, rs: ReadSet) -> str:
    """Fastq of unmatched unique reads: name#count / seq / + / '!'*len
    (cmd/muscato_nonmatch/main.go:95-107), exact membership."""
    matched = np.zeros(rs.num_unique, dtype=bool)
    if len(mr.read_row):
        matched[np.unique(mr.read_row)] = True
    rows = np.flatnonzero(~matched).astype(np.int64)
    out = nonmatch_path(results_path)

    n = len(rows)
    rl = rs.lengths.astype(np.int64)[rows]
    nlen = np.diff(rs.name_off)[rows]
    cnt = rs.counts[rows].astype("S20")
    clen = np.char.str_len(cnt).astype(np.int64)
    # name#count\nseq\n+\n!!!\n
    row_len = nlen + 1 + clen + 1 + rl + 3 + rl + 1
    row_end = np.cumsum(row_len)
    row_start = row_end - row_len
    blob = np.zeros(int(row_end[-1]) if n else 0, np.uint8)
    at = row_start
    ranged_copy(blob, at, rs.name_blob, rs.name_off[:-1][rows], nlen)
    at = at + nlen
    blob[at] = ord("#")
    cbuf = np.frombuffer(cnt.tobytes(), np.uint8)
    ranged_copy(blob, at + 1, cbuf, np.arange(n, dtype=np.int64) * 20, clen)
    at = at + 1 + clen
    blob[at] = ord("\n")
    decode_rows_blob(blob, at + 1, rs.codes, rs.codes.shape[1], rows, rl, _C2B)
    at = at + 1 + rl
    blob[at] = ord("\n")
    blob[at + 1] = ord("+")
    blob[at + 2] = ord("\n")
    # constant '!' qualities: a ranged copy from one max-length row
    # (expanding the ranges into a flat index array costs ~20s at 2M
    # reads; the C ranged copy does the same fill in ~0.2s)
    qual = np.full(int(rl.max(initial=1)), ord("!"), np.uint8)
    ranged_copy(blob, at + 3, qual, np.zeros(n, np.int64), rl)
    blob[at + 3 + rl] = ord("\n")
    with open(out, "wb") as f:
        blob.tofile(f)
    return out


def _stats_path(results_path: str, tag: str) -> str:
    """<results>_<tag>.<ext> naming (cmd/muscato_readstats/main.go:52-59)."""
    root, ext = os.path.splitext(results_path)
    if ext:
        return root + "_" + tag + ext
    return results_path + "_" + tag


def write_readstats(results_path: str, t: ResultsTable) -> str:
    """Group results rows by the names column (field 7) over consecutive
    runs in results order; emit the distinct gene set (sorted) per group:
    "readid\\tg1;g2;...;" (cmd/muscato_readstats/main.go:74-108)."""
    out = _stats_path(results_path, "readstats")
    n = t.nrows
    if n == 0:
        with open(out, "wb") as f:
            # Degenerate empty-results row, as the reference emits
            # (cmd/muscato_readstats/main.go:109-114 writes the final
            # group unconditionally).
            f.write(b"\t\n")
        return out

    names_s = _fixed_view([t.names], 0)
    genes_s = _fixed_view([t.gene], 0)
    grp = np.concatenate([[True], names_s[1:] != names_s[:-1]])
    gid = np.cumsum(grp) - 1
    # distinct (group, gene), gene-sorted within group
    order = np.lexsort((genes_s, gid))
    gid_o, gene_o = gid[order], genes_s[order]
    first = np.concatenate(
        [[True], (gid_o[1:] != gid_o[:-1]) | (gene_o[1:] != gene_o[:-1])]
    )
    gid_u, gene_u = gid_o[first], gene_o[first]
    glen_u = np.char.str_len(gene_u).astype(np.int64)
    gblob = np.frombuffer(gene_u.tobytes(), np.uint8)
    gw = gene_u.dtype.itemsize

    # per output group: name \t gene; gene; ... \n
    heads = np.flatnonzero(grp)  # first results-row of each group
    ng = len(heads)
    genes_per = np.bincount(gid_u, minlength=ng)
    gene_bytes = np.zeros(ng, np.int64)
    np.add.at(gene_bytes, gid_u, glen_u + 1)  # each gene gets a ';'
    nm_len = t.names.lens[heads]
    row_len = nm_len + 1 + gene_bytes + 1
    row_end = np.cumsum(row_len)
    row_start = row_end - row_len
    blob = np.zeros(int(row_end[-1]), np.uint8)
    blob[_gather_ranges(row_start, nm_len)] = t.names.blob[
        _gather_ranges(t.names.starts[heads], nm_len)
    ]
    blob[row_start + nm_len] = ord("\t")
    # gene list area: compute each distinct gene's output start
    seg_end_per_gene = np.cumsum(glen_u + 1)
    seg_start_per_gene = seg_end_per_gene - (glen_u + 1)
    grp_base = np.zeros(ng, np.int64)
    grp_first_gene = np.cumsum(genes_per) - genes_per
    grp_base = (row_start + nm_len + 1) - seg_start_per_gene[grp_first_gene]
    gdst = grp_base[gid_u] + seg_start_per_gene
    blob[_gather_ranges(gdst, glen_u)] = gblob[
        _gather_ranges(np.arange(len(gid_u), dtype=np.int64) * gw, glen_u)
    ]
    blob[gdst + glen_u] = ord(";")
    blob[row_end - 1] = ord("\n")
    with open(out, "wb") as f:
        blob.tofile(f)
    return out


def write_genestats(results_path: str, t: ResultsTable) -> str:
    """Per-gene row counts over results sorted by `sort -k5` (field 5
    through end of line, reference cmd/muscato/main.go:103-108):
    "gene\\tcount\\t" (cmd/muscato_genestats/main.go:33-55)."""
    out = _stats_path(results_path, "genestats")
    n = t.nrows
    if n == 0:
        with open(out, "wb") as f:
            f.write(b"\t0\t\n")
        return out
    k5 = _fixed_view([t.gene, t.glen, t.copies, t.names], ord("\t"))
    order = np.argsort(k5, kind="stable")
    gene_s = _fixed_view([t.gene], 0)[order]
    first = np.concatenate([[True], gene_s[1:] != gene_s[:-1]])
    uniq = gene_s[first]
    counts = np.diff(np.append(np.flatnonzero(first), n))
    glen = np.char.str_len(uniq).astype(np.int64)
    gw = uniq.dtype.itemsize
    gblob = np.frombuffer(uniq.tobytes(), np.uint8)
    cnt = counts.astype("S20")
    clen = np.char.str_len(cnt).astype(np.int64)
    cbuf = np.frombuffer(cnt.tobytes(), np.uint8)
    m = len(uniq)
    row_len = glen + 1 + clen + 2
    row_end = np.cumsum(row_len)
    row_start = row_end - row_len
    blob = np.zeros(int(row_end[-1]), np.uint8)
    blob[_gather_ranges(row_start, glen)] = gblob[
        _gather_ranges(np.arange(m, dtype=np.int64) * gw, glen)
    ]
    blob[row_start + glen] = ord("\t")
    blob[_gather_ranges(row_start + glen + 1, clen)] = cbuf[
        _gather_ranges(np.arange(m, dtype=np.int64) * 20, clen)
    ]
    blob[row_start + glen + 1 + clen] = ord("\t")
    blob[row_end - 1] = ord("\n")
    with open(out, "wb") as f:
        blob.tofile(f)
    return out
