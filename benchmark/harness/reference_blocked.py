"""The plain reference of ``reference.py``, with its window index built in
blocks of target positions, for gene sets whose whole index would not fit
the card beside what the run keeps there (1.5e9 positions: ``Reference``
keys and sorts every window at once in int64 tensors).

The semantics are ``reference.py``'s, rule for rule (its docstring): the
seeds, the q1 = 0 quirk of the position-0 screen, the mismatch budget and
its ``budget_delta`` control, the (read, gene, start) dedup, best+MMTol,
and the MaxMatches check.  Only the index differs: ``match`` keys and
sorts the windows that start in ``[b0, b1)`` one block at a time, from the
bases ``tcat[b0 : b1 + W - 1]``, so that no window that straddles a
block's bound is lost; searches every read window in the block; and
verifies, dedups and ranks the hits of all blocks together, as
``Reference`` does over its one index.  Nothing of the index outlives a
call of ``match``.  It imports nothing but torch, numpy and
``reference.py``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.harness.reference import (MAX_WIDTH, PAIR_BLOCK, READ_BLOCK, Reference,
                                         _base5, _lexsorted_unique)

POS_BLOCK = 1 << 27  # window positions keyed and sorted a block (~10 GB at a time)


class BlockedReference(Reference):
    """``Reference`` over the genes ``tcat`` (S,) uint8 with genes at
    ``gene_start`` (G+1,), on tcat's device, with its index built anew in
    blocks of ``block`` window positions in each ``match``."""

    def __init__(self, tcat: torch.Tensor, gene_start, *, windows, width: int, pmatch: float,
                 min_dinuc: int, max_read_length: int, mmtol: int, max_matches: int,
                 match_mode: str, block: int = POS_BLOCK):
        if width > MAX_WIDTH:
            raise ValueError(f"the reference keys windows of at most {MAX_WIDTH} bases")
        if match_mode != "best":
            raise NotImplementedError("the reference models MatchMode best only")
        dev = tcat.device
        self.tcat, self.dev, self.block = tcat, dev, int(block)
        self.gene_start = torch.as_tensor(np.asarray(gene_start, dtype=np.int64), device=dev)
        self.windows = [int(q) for q in windows]
        self.width, self.min_dinuc = int(width), int(min_dinuc)
        self.max_read_length, self.mmtol = int(max_read_length), int(mmtol)
        self.max_matches = int(max_matches)
        self.budget = torch.tensor(
            [math.trunc((1.0 - float(pmatch)) * n) for n in range(max_read_length + 1)],
            dtype=torch.int64, device=dev)
        self.nwin = max(tcat.shape[0] - self.width + 1, 0)

    def _index_block(self, b0: int, b1: int) -> tuple:
        """(keys, positions) of the valid windows starting in [b0, b1),
        sorted by key, ties by position."""
        n = b1 - b0
        pos = torch.arange(b0, b1, device=self.dev)
        gene = torch.searchsorted(self.gene_start, pos, right=True) - 1
        inside = pos + self.width <= self.gene_start[gene + 1]
        del gene
        bases = self.tcat[b0:b1 + self.width - 1]
        key = _base5(bases[i:i + n] for i in range(self.width))
        keys, order = torch.sort(key[inside], stable=True)
        return keys, pos[inside][order]

    def match(self, codes: torch.Tensor, lengths: torch.Tensor,
              budget_delta: int = 0) -> torch.Tensor:
        """``Reference.match``: the (M, 4) int64 rows (read, gene, start,
        mismatches) of the reads, in (read, gene, start) order."""
        codes, lengths = codes.to(self.dev), lengths.to(self.dev).to(torch.int64)
        starts = range(0, codes.shape[0], READ_BLOCK)
        seeds = [[self._seeds(codes[b0:b0 + READ_BLOCK], lengths[b0:b0 + READ_BLOCK], q1)
                  for q1 in self.windows] for b0 in starts]
        hits = [[[] for _ in self.windows] for _ in starts]  # (reads, positions) a block
        for p0 in range(0, self.nwin, self.block):
            keys, pos = self._index_block(p0, min(p0 + self.block, self.nwin))
            for j, per_window in enumerate(seeds):
                for k, (valid, key) in enumerate(per_window):
                    lo = torch.searchsorted(keys, key, side="left")
                    hi = torch.searchsorted(keys, key, side="right")
                    count = torch.where(valid, hi - lo, 0)
                    total = int(count.sum())
                    if not total:
                        continue
                    reads = torch.repeat_interleave(
                        torch.arange(key.shape[0], device=self.dev), count)
                    first = torch.cumsum(count, 0) - count
                    at = lo[reads] + torch.arange(total, device=self.dev) - first[reads]
                    hits[j][k].append((reads, pos[at]))
            del keys, pos
        found, groups = [], [[] for _ in self.windows]
        for j, b0 in enumerate(starts):
            bc, bl = codes[b0:b0 + READ_BLOCK], lengths[b0:b0 + READ_BLOCK]
            for k, q1 in enumerate(self.windows):
                if not hits[j][k]:
                    continue
                reads = torch.cat([r for r, _ in hits[j][k]])
                places = torch.cat([p for _, p in hits[j][k]])
                key = seeds[j][k][1]
                for c0 in range(0, reads.shape[0], PAIR_BLOCK):
                    r, p = reads[c0:c0 + PAIR_BLOCK], places[c0:c0 + PAIR_BLOCK]
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
            best = torch.full((codes.shape[0],), torch.iinfo(torch.int64).max, device=self.dev)
            best.scatter_reduce_(0, rows[:, 0], rows[:, 3], reduce="amin")
            rows = rows[rows[:, 3] <= best[rows[:, 0]] + self.mmtol]
        return rows
