"""Runs against gene sets too large for a CPU reference, held exactly to a
CPU run over a subset of their genes.

A run on the card against 1.5e9 or 2.4e9 bases cannot be repeated on the
CPU whole.  ``plant_reads`` makes reads whose every match lies in a known
set of genes: three quarters are copied from genes of that set with 0-5
substitutions (past the flagship's 4-mismatch budget at 5), one quarter
are random; and some are copied into 2-4 genes at once with different
substitution counts, so that best+MMTol has to choose between genes (and
between gene-range shards when the genes lie in different shards;
``Plants.best_genes`` says which it keeps), each with four near copies
differing from it in one of their first two or last two bases only, so
that its cap groups hold several reads' rows and a MaxMatches cap binds.
``oracle`` then runs the port on the CPU over those genes alone and maps
the gene ids back.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..config import Config
from ..io.reads import ReadSet
from ..io.targets import TargetSet

PLANTED_SHARE = 0.75  # of the reads; the rest are random
READ_LEN = 100  # the flagship's read length
MAX_SUBS = 5  # substitutions a planted read has at most: one past the budget of 4
# The read positions no group copy substitutes (the flagship's first window,
# so that every copy is a candidate), and the base each near copy of a
# group's read changes: its first two and its last two, outside every
# window of the flagship's configuration (10-89).
EXACT = (10, 30)
_NEAR = (0, 1, -1, -2)


def _substitute(codes: np.ndarray, nsub: np.ndarray, rng, keep=(0, 0)) -> np.ndarray:
    """``codes`` (n, L) uint8 with nsub[i] distinct positions of row i,
    none in columns [keep[0], keep[1]), changed to another base each."""
    n, length = codes.shape
    out = codes.copy()
    if not n:
        return out
    most = int(nsub.max(initial=0))
    draw = rng.random((n, length))
    draw[:, keep[0]:keep[1]] = 2.0  # sorted after every free column
    cols = np.argsort(draw, axis=1)[:, :most]
    rows = np.repeat(np.arange(n), most).reshape(n, most)
    live = np.arange(most)[None, :] < nsub[:, None]
    r, c = rows[live], cols[live]
    out[r, c] = (out[r, c] + rng.integers(1, 4, r.size, dtype=np.uint8)) % 4
    return out


@dataclass
class Plants:
    """What ``plant_reads`` planted: ``genes``, the sorted ids of every
    gene a read was copied from; ``groups``, for each group its genes, the
    substitution count of its copy in each, and the ReadSet row of its
    read X."""

    genes: np.ndarray
    groups: list = field(default_factory=list)  # (genes, substitutions, read row)

    def best_genes(self, budget: int, mmtol: int) -> dict:
        """{read row: genes} that a ``best``-mode run reports for each
        group's read X when ``budget`` is its mismatch budget: the genes
        whose copy lies within the budget and within ``mmtol`` of the
        group's fewest substitutions.  Each copy keeps the first window
        (EXACT) unchanged, so each is a candidate, and X lies exactly its
        substitution count from it."""
        out = {}
        for genes, subs, row in self.groups:
            least = int(subs.min())
            out[row] = {int(g) for g, c in zip(genes, subs)
                        if c <= budget and c <= least + mmtol}
        return out


def plant_reads(ts: TargetSet, genes, num_reads: int, groups=(), *,
                seed: int = 0) -> tuple[ReadSet, Plants]:
    """Reads planted in ``genes`` of ``ts``, and what was planted.

    Each of ``groups`` (tuples of 2-4 distinct genes, no gene in two
    groups) takes a READ_LEN-base segment X of its first gene; a copy of
    X with its own count of substitutions (0..MAX_SUBS, distinct within
    the group, none at the read positions EXACT) is written over a
    segment of each gene of the group, the first gene's own included
    (``ts.tcat`` changes in place).  X and four near copies of it (one of
    its first two or last two bases changed) are reads.  Then PLANTED_SHARE of ``num_reads`` less those are
    READ_LEN-base segments of random genes of ``genes`` at random
    offsets, each with 0 to MAX_SUBS substitutions, and the rest random
    sequences.  Every gene must be at least READ_LEN bases long.  The
    reads are deduplicated and sorted as read prep leaves them."""
    rng = np.random.default_rng(seed)
    gs = np.asarray(ts.gene_start, dtype=np.int64)
    genes = np.asarray(genes, dtype=np.int64)
    reads, made = [], []
    for group in groups:
        group = np.asarray(group, dtype=np.int64)
        glen = gs[group + 1] - gs[group]
        at = gs[group] + rng.integers(0, glen - READ_LEN + 1)
        x = ts.tcat[at[0]:at[0] + READ_LEN].copy()
        subs = rng.choice(MAX_SUBS + 1, group.size, replace=False)
        copies = _substitute(np.repeat(x[None], group.size, axis=0), subs, rng, EXACT)
        for a, row in zip(at, copies):
            ts.tcat[a:a + READ_LEN] = row
        near = np.repeat(x[None], len(_NEAR), axis=0)
        near[np.arange(len(_NEAR)), _NEAR] += 1
        near %= 4
        reads += [x[None], near]
        made.append((group, subs, x))
    nplant = int(num_reads * PLANTED_SHARE) - sum(len(r) for r in reads)
    g = genes[rng.integers(0, genes.size, nplant)]
    at = gs[g] + rng.integers(0, gs[g + 1] - gs[g] - READ_LEN + 1)
    seg = ts.tcat[at[:, None] + np.arange(READ_LEN)]
    reads.append(_substitute(seg, rng.integers(0, MAX_SUBS + 1, nplant), rng))
    nrand = num_reads - sum(len(r) for r in reads)
    reads.append(rng.integers(0, 4, (nrand, READ_LEN), dtype=np.uint8))
    codes = np.ascontiguousarray(np.concatenate(reads))
    uniq, counts = np.unique(codes.view(f"V{READ_LEN}").ravel(), return_counts=True)
    ucodes = np.frombuffer(uniq.tobytes(), dtype=np.uint8).reshape(-1, READ_LEN)
    rs = ReadSet(codes=ucodes, lengths=np.full(len(uniq), READ_LEN, np.int32),
                 counts=counts.astype(np.int64),
                 names=[b"read_%d" % i for i in range(len(uniq))], num_total=num_reads)
    plants = Plants(genes=np.union1d(genes, np.concatenate(
        [genes[:0], *(group for group, _, _ in made)])))
    for group, subs, x in made:
        row = int(np.searchsorted(uniq, np.ascontiguousarray(x).view(f"V{READ_LEN}")[0]))
        plants.groups.append((group, subs, row))
    return rs, plants


def subset_targets(ts: TargetSet, genes) -> TargetSet:
    """Genes ``genes`` (sorted ids) of ``ts`` as a TargetSet of their own,
    in that order."""
    genes = np.asarray(genes, dtype=np.int64)
    gs = np.asarray(ts.gene_start, dtype=np.int64)
    lengths = gs[genes + 1] - gs[genes]
    tcat = (np.concatenate([ts.tcat[gs[g]:gs[g + 1]] for g in genes]) if genes.size
            else np.zeros(0, np.uint8))
    return TargetSet(tcat=tcat, gene_start=np.concatenate([[0], np.cumsum(lengths)]),
                     names=[ts.names[g] for g in genes],
                     lengths=np.asarray(ts.lengths)[genes])


def oracle(cfg: Config, rs: ReadSet, ts: TargetSet, named, planted):
    """The MatchResult of ``cfg`` over ``rs`` and ``ts``, computed on the
    CPU (the kernels' plain twins) over the genes ``named`` (the genes the
    run under test reports) and ``planted`` alone, with the gene ids mapped
    back to ``ts``'s.

    It equals the whole run's whenever every match of the whole run lies
    in one of those genes.  For reads from ``plant_reads`` over random
    genes that holds: a gene no read was planted in is a random sequence,
    and a 100-base read (planted or random) lies within the 4-mismatch
    budget of a given random window with a chance of about 2e-52 (about
    3e-37 over 524,288 reads and 2.4e9 windows), so no survivor comes from
    it.  The MaxMatches cap and best+MMTol act only on
    survivors: a cap group holds the survivors of one window key, all in
    planted genes, and the genes keep their relative order (the subset is
    in ascending id order), as do the reads and starts, so the cap keeps
    the same rows and each read's best is the same.  A gene that the run
    under test reports beyond the planted ones joins the subset, so that a
    spurious match there is checked rather than missed."""
    from ..engine import pipeline

    genes = np.union1d(np.asarray(named, np.int64), np.asarray(planted, np.int64))
    mr = pipeline.run_matching(cfg, rs, subset_targets(ts, genes), device="cpu")
    return pipeline.MatchResult(mr.read_row, genes[mr.gene].astype(np.int32), mr.start,
                                mr.nmiss)
