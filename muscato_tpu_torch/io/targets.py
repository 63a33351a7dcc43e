"""Target (gene) database preparation and loading.

Equivalent of muscato_prep_targets (/root/reference/cmd/muscato_prep_targets/
main.go): converts a fasta file or an `id<TAB>seq` text file (optionally
.gz / .sz compressed) into the prepared pair of files

    musc_<name>.sz      one plain sequence per line (subx applied)
    musc_ids_<name>.sz  "%011d<TAB>name<TAB>length" per line

with optional reverse-complement interleaving (`-rev`): each sequence is
followed by its reverse complement whose id gets an "_r" suffix
(main.go:107-137).

Reference quirks preserved:
  - fasta detection is by the *raw* file name ending in "fasta"
    (main.go:321-322) — "genes.fasta.gz" is treated as text;
  - fasta record names keep the full header line including '>'
    (main.go:186; verified against tests/data/prep_targets/00);
  - text-format parsing stops at the first empty line (main.go:94-96);
  - output names strip one trailing .gz/.sz (case-insensitively) and
    append .sz (main.go:296-316).

Deliberate deviation: the reference forgets subx on the *final* fasta record
(main.go:203-211 calls flush without subx); we apply subx uniformly.  The
golden data never exercises this (all-ACGT inputs).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from . import seqcodec, sz


def prepared_names(rawgenefile: str) -> Tuple[str, str]:
    """Output (sequence, ids) file names for a raw input path."""

    def mk(prefix: str) -> str:
        d, f = os.path.split(rawgenefile)
        f = prefix + f
        if f.lower().endswith(".gz"):
            f = f[:-3]
        if f.lower().endswith(".sz"):
            f = f[:-3]
        return os.path.join(d, f + ".sz")

    return mk("musc_"), mk("musc_ids_")


def _iter_text(lines: List[bytes]):
    for line in lines:
        if len(line) == 0:
            break
        toks = line.split(b"\t")
        if len(toks) != 2:
            raise SystemExit(
                "Text format gene file should have two tab-delimited tokens per row."
            )
        yield toks[0], toks[1]


def _iter_fasta(lines: List[bytes]):
    name = None
    seq = bytearray()
    for line in lines:
        if line.startswith(b">"):
            if len(seq) > 0:
                yield name, bytes(seq)
            name = line
            seq = bytearray()
        else:
            seq += line
    if len(seq) > 0:
        yield name, bytes(seq)


def prep_targets(rawgenefile: str, rev: bool = False) -> Tuple[str, str]:
    """Prepare a raw gene file; returns (seq_path, ids_path)."""
    data = sz.read_bytes(rawgenefile)
    lines = data.split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()

    is_fasta = rawgenefile.lower().endswith("fasta")
    records = _iter_fasta(lines) if is_fasta else _iter_text(lines)

    seq_out = bytearray()
    ids_out = bytearray()
    lnum = 0
    for name, rawseq in records:
        seq = seqcodec.subx_bytes(rawseq)
        seq_out += seq + b"\n"
        ids_out += b"%011d\t%s\t%d\n" % (lnum, name, len(seq))
        lnum += 1
        if rev:
            rseq = seqcodec.revcomp_bytes(seq)
            seq_out += rseq + b"\n"
            ids_out += b"%011d\t%s_r\t%d\n" % (lnum, name, len(seq))
            lnum += 1

    seq_path, ids_path = prepared_names(rawgenefile)
    sz.write_bytes(seq_path, bytes(seq_out))
    sz.write_bytes(ids_path, bytes(ids_out))
    return seq_path, ids_path


@dataclass
class TargetSet:
    """A loaded prepared target database, as dense arrays.

    tcat        (S,) uint8 codes — all gene sequences concatenated
    gene_start  (G+1,) int64 — offsets of each gene in tcat (last = S)
    names       list of G byte-string gene names (as in the ids file)
    lengths     (G,) int64 — declared lengths from the ids file
    """

    tcat: np.ndarray
    gene_start: np.ndarray
    names: List[bytes] = field(default_factory=list)
    lengths: np.ndarray = None

    @property
    def num_genes(self) -> int:
        return len(self.gene_start) - 1

    @property
    def size(self) -> int:
        return int(self.gene_start[-1])


def load_targets(gene_file: str, gene_id_file: str) -> TargetSet:
    """Load prepared sequence + id files into a TargetSet."""
    seq_data = sz.read_bytes(gene_file)
    seqs = seq_data.split(b"\n")
    if seqs and seqs[-1] == b"":
        seqs.pop()

    ids_data = sz.read_bytes(gene_id_file)
    id_lines = ids_data.split(b"\n")
    if id_lines and id_lines[-1] == b"":
        id_lines.pop()

    names: List[bytes] = []
    lengths = np.empty(len(id_lines), dtype=np.int64)
    for i, line in enumerate(id_lines):
        toks = line.split(b"\t")
        # "%011d \t name \t len"
        names.append(toks[1])
        lengths[i] = int(toks[2])

    if len(seqs) != len(names):
        raise ValueError(
            f"gene file has {len(seqs)} sequences but id file has {len(names)} entries"
        )

    gene_start = np.zeros(len(seqs) + 1, dtype=np.int64)
    for i, s in enumerate(seqs):
        gene_start[i + 1] = gene_start[i] + len(s)
    tcat = np.empty(int(gene_start[-1]), dtype=np.uint8)
    for i, s in enumerate(seqs):
        tcat[gene_start[i] : gene_start[i + 1]] = seqcodec.encode(s)

    return TargetSet(tcat=tcat, gene_start=gene_start, names=names, lengths=lengths)
