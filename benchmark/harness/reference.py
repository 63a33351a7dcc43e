"""A plain reference of muscato's matching, written from upstream's
semantics in plain PyTorch: it holds the matches that the benchmark
compares the program's results with.  It imports nothing but torch and
numpy, and it takes only the genes and the reads that the benchmark made.

For each read and each window offset q1 of width W:

  - the window seeds only if the read is at least q1 + W long and, with
    MinDinuc > 0, holds at least MinDinuc distinct adjacent base pairs
    (over the five codes A C G T X);
  - it seeds at every target position p whose W bases equal the read's
    window, where [p, p + W) lies inside one gene;
  - a seed at p, inside gene g at p_local = p - start(g), places the read
    at s = p_local - q1, which must be >= 0;
  - the read must end inside the gene and be at most MaxReadLength long:
    s + len <= min(gene length, s + MaxReadLength); where q1 = 0 and
    p_local = 0, upstream's screen caps the gene at 100 - W bases
    (a hard-coded constant, kept);
  - its mismatches, over the whole read, are at most int((1 - PMatch) *
    len), computed in float64 and truncated (X equals X);
  - each (read, gene, s) counts once; in ``best`` mode a read keeps the
    rows whose mismatches are at most its least plus MMTol.

MaxMatches caps the matches of one (window, window bases) group; the
reference does not model which ones a binding cap keeps, and raises if a
group passes the cap.
"""

from __future__ import annotations

import math

import numpy as np
import torch

NCODE = 5
MAX_WIDTH = 27  # the widest window whose base-5 value fits an int64
READ_BLOCK = 1 << 18  # reads a step
PAIR_BLOCK = 1 << 20  # candidate placements verified a step


def _base5(cols) -> torch.Tensor:
    """The base-5 value of the given code columns, most significant first."""
    key = None
    for c in cols:
        key = c.to(torch.int64) if key is None else key * NCODE + c
    return key


class Reference:
    """The window index of the genes ``tcat`` (S,) uint8 codes with genes
    at ``gene_start`` (G+1,), on tcat's device, and the matching of reads
    against it."""

    def __init__(self, tcat: torch.Tensor, gene_start, *, windows, width: int, pmatch: float,
                 min_dinuc: int, max_read_length: int, mmtol: int, max_matches: int,
                 match_mode: str):
        if width > MAX_WIDTH:
            raise ValueError(f"the reference keys windows of at most {MAX_WIDTH} bases")
        if match_mode != "best":
            raise NotImplementedError("the reference models MatchMode best only")
        dev = tcat.device
        self.tcat, self.dev = tcat, dev
        self.gene_start = torch.as_tensor(np.asarray(gene_start, dtype=np.int64), device=dev)
        self.windows = [int(q) for q in windows]
        self.width, self.min_dinuc = int(width), int(min_dinuc)
        self.max_read_length, self.mmtol = int(max_read_length), int(mmtol)
        self.max_matches = int(max_matches)
        self.budget = torch.tensor(
            [math.trunc((1.0 - float(pmatch)) * n) for n in range(max_read_length + 1)],
            dtype=torch.int64, device=dev)
        s = tcat.shape[0]
        nwin = max(s - self.width + 1, 0)
        pos = torch.arange(nwin, device=dev)
        gene = torch.searchsorted(self.gene_start, pos, right=True) - 1
        inside = pos + self.width <= self.gene_start[gene + 1]
        key = _base5(tcat[i:i + nwin] for i in range(self.width))
        self.keys, order = torch.sort(key[inside], stable=True)
        self.pos = pos[inside][order]

    def _seeds(self, codes, lengths, q1: int):
        """(valid, key) of window q1 of each read."""
        w = self.width
        valid = lengths >= q1 + w
        if q1 + w > codes.shape[1]:
            return valid, torch.zeros_like(lengths, dtype=torch.int64)
        win = codes[:, q1:q1 + w].to(torch.int64)
        if self.min_dinuc > 0:
            seen = torch.zeros(codes.shape[0], dtype=torch.int64, device=self.dev)
            for i in range(w - 1):
                seen |= 1 << (win[:, i] * NCODE + win[:, i + 1])
            distinct = sum((seen >> b) & 1 for b in range(NCODE * NCODE))
            valid &= distinct >= self.min_dinuc
        return valid, _base5(win[:, i] for i in range(w))

    def _verify(self, codes, lengths, r, p, q1: int, budget_delta: int):
        """(keep, gene, start, mismatches) of the placements of reads r
        seeded at positions p by window q1."""
        g = torch.searchsorted(self.gene_start, p, right=True) - 1
        gstart = self.gene_start[g]
        glen = self.gene_start[g + 1] - gstart
        p_local = p - gstart
        s = p_local - q1
        n = lengths[r].to(torch.int64)
        fits = (s + n <= glen) & (n <= self.max_read_length)
        if q1 == 0:
            quirk = (p_local == 0) & (n <= glen) & (n <= 100 - self.width)
            fits = torch.where(p_local == 0, quirk, fits)
        keep = (s >= 0) & fits
        base = p - q1
        nx = torch.zeros_like(p)
        last = self.tcat.shape[0] - 1
        for c in range(codes.shape[1]):
            t = self.tcat[(base + c).clamp(0, last)]
            nx += ((t != codes[r, c]) & (c < n)).to(torch.int64)
        keep &= nx <= self.budget[n.clamp(max=self.budget.shape[0] - 1)] + budget_delta
        return keep, g, s, nx

    def match(self, codes: torch.Tensor, lengths: torch.Tensor,
              budget_delta: int = 0) -> torch.Tensor:
        """The matches of reads ``codes`` (N, L) uint8 with ``lengths`` (N,):
        (M, 4) int64 rows (read, gene, start, mismatches) in (read, gene,
        start) order, on the reference's device.  ``budget_delta`` shifts the mismatch budget: a
        control breaks the PMatch guarantee with -1."""
        codes, lengths = codes.to(self.dev), lengths.to(self.dev).to(torch.int64)
        found, groups = [], [[] for _ in self.windows]
        for b0 in range(0, codes.shape[0], READ_BLOCK):
            bc, bl = codes[b0:b0 + READ_BLOCK], lengths[b0:b0 + READ_BLOCK]
            for k, q1 in enumerate(self.windows):
                valid, key = self._seeds(bc, bl, q1)
                lo = torch.searchsorted(self.keys, key, side="left")
                hi = torch.searchsorted(self.keys, key, side="right")
                count = torch.where(valid, hi - lo, 0)
                total = int(count.sum())
                reads = torch.repeat_interleave(torch.arange(bc.shape[0], device=self.dev),
                                                count)
                first = torch.cumsum(count, 0) - count
                at = lo[reads] + torch.arange(total, device=self.dev) - first[reads]
                for c0 in range(0, total, PAIR_BLOCK):
                    r = reads[c0:c0 + PAIR_BLOCK]
                    p = self.pos[at[c0:c0 + PAIR_BLOCK]]
                    keep, g, s, nx = self._verify(bc, bl, r, p, q1, budget_delta)
                    found.append(torch.stack([r[keep] + b0, g[keep], s[keep], nx[keep]], 1))
                    groups[k].append(key[r[keep]])
        for keys in filter(None, groups):
            _, sizes = torch.unique(torch.cat(keys), return_counts=True)
            if sizes.numel() and int(sizes.max()) > self.max_matches:
                raise RuntimeError("a (window, bases) group passes MaxMatches: the "
                                   "reference does not model which matches the cap keeps")
        rows = (torch.cat(found) if found
                else torch.zeros((0, 4), dtype=torch.int64, device=self.dev))
        rows = _lexsorted_unique(rows)
        if rows.shape[0]:
            nreads = codes.shape[0]
            best = torch.full((nreads,), torch.iinfo(torch.int64).max, device=self.dev)
            best.scatter_reduce_(0, rows[:, 0], rows[:, 3], reduce="amin")
            rows = rows[rows[:, 3] <= best[rows[:, 0]] + self.mmtol]
        return rows


def _lexsorted_unique(rows: torch.Tensor) -> torch.Tensor:
    """The distinct rows of (M, 4) by (read, gene, start), in that order:
    a placement's mismatches follow from the other three columns."""
    order = torch.arange(rows.shape[0], device=rows.device)
    for col in (2, 1, 0):
        order = order[torch.sort(rows[order, col], stable=True).indices]
    rows = rows[order]
    if rows.shape[0] > 1:
        new = torch.ones(rows.shape[0], dtype=torch.bool, device=rows.device)
        new[1:] = (rows[1:, :3] != rows[:-1, :3]).any(1)
        rows = rows[new]
    return rows

