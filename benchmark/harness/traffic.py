"""The genes and the read pool of a cell, made from the seed on the device.

The model is the port's ``bench/gendat.py`` ``generate_arrays_realistic``
(the intent of upstream's bigtest and of resequencing data), rewritten so
that a 4M-read pool takes well under a second on the card:

  - genes: ``count`` genes of ``length`` uniform bases (codes 0-3);
  - sampled reads: a uniform gene, a uniform offset in
    [0, length - read_length), the gene's bases there, each base replaced
    with probability ``sub_rate`` by a uniform base (which may equal it);
  - random reads: ``frac_random`` of the reads are uniform bases;
  - the pool is deduplicated and sorted as read prep hands reads to the
    engine (C-locale order of the rows, ``np.unique`` of gendat);
  - with ``planted`` > 0, upstream's own gendat model
    (``cmd/muscato_gendat/main.go``): in the first ``planted_genes`` share
    of the genes, gene i carries an exact copy of planted read i % planted
    at offset i % planted.  The planted reads are pool rows that every
    call takes.

Every draw comes from one ``torch.Generator`` on the device seeded with
the run's seed, in fixed-size blocks, so the same seed gives the same
genes and pool on the same kind of device.  ``gendat`` draws from numpy's
generator instead: the distributions are the same, the bytes are not.
"""

from __future__ import annotations

import numpy as np
import torch

STEP_BASES = 1 << 26  # bases drawn a step, which bounds the index tensors
DIGITS = 27  # base-5 digits an int64 word holds (5**27 < 2**63)


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & ((1 << 64) - 1))
    return g


def make_genes(count: int, length: int, gen: torch.Generator) -> torch.Tensor:
    """(count * length,) uint8 codes on the generator's device."""
    return torch.randint(0, 4, (count * length,), generator=gen, device=gen.device,
                         dtype=torch.uint8)


def make_reads(genes: torch.Tensor, count: int, length: int, read_length: int, n: int,
               *, frac_random: float, sub_rate: float, gen: torch.Generator) -> torch.Tensor:
    """(n, read_length) uint8 codes, unsorted: the first int(n *
    frac_random) rows random, the rest sampled from the genes."""
    dev = gen.device
    out = torch.empty((n, read_length), dtype=torch.uint8, device=dev)
    nrand = int(n * frac_random)
    cols = torch.arange(read_length, device=dev)
    step = max(1, STEP_BASES // read_length)
    for b0 in range(0, nrand, step):
        b1 = min(nrand, b0 + step)
        out[b0:b1] = torch.randint(0, 4, (b1 - b0, read_length), generator=gen, device=dev,
                                   dtype=torch.uint8)
    for b0 in range(nrand, n, step):
        b1 = min(n, b0 + step)
        m = b1 - b0
        g = torch.randint(0, count, (m,), generator=gen, device=dev)
        off = torch.randint(0, length - read_length, (m,), generator=gen, device=dev)
        rows = genes[(g * length + off)[:, None] + cols]
        mut = torch.rand((m, read_length), generator=gen, device=dev) < sub_rate
        sub = torch.randint(0, 4, (m, read_length), generator=gen, device=dev,
                            dtype=torch.uint8)
        out[b0:b1] = torch.where(mut, sub, rows)
    return out


def sort_unique(codes: torch.Tensor) -> torch.Tensor:
    """The distinct rows of ``codes`` (n, L) uint8 in lexicographic order:
    each row as base-5 words of DIGITS codes, most significant first,
    ordered by stable sorts from the last word to the first."""
    n, length = codes.shape
    words = []
    for c0 in range(0, length, DIGITS):
        w = torch.zeros(n, dtype=torch.int64, device=codes.device)
        for c in range(c0, c0 + DIGITS):
            w *= 5
            if c < length:
                w += codes[:, c]
        words.append(w)
    perm = torch.arange(n, device=codes.device)
    for w in reversed(words):
        perm = perm[torch.sort(w[perm], stable=True).indices]
    new = torch.ones(n, dtype=torch.bool, device=codes.device)
    if n > 1:
        same = torch.ones(n - 1, dtype=torch.bool, device=codes.device)
        for w in words:
            ws = w[perm]
            same &= ws[1:] == ws[:-1]
        new[1:] = ~same
    return codes[perm[new]]


def plant(genes: torch.Tensor, count: int, length: int, pool: torch.Tensor, per_call: int,
          planted: int, share: float, gen: torch.Generator) -> None:
    """Write ``planted`` reads of ``pool`` into ``genes`` in place as
    upstream's gendat does: gene i < int(count * share) gets read i %
    planted at offset i % planted (cut at the gene's end).  The reads are
    drawn from the rows that every call of ``per_call`` consecutive rows
    holds."""
    span = len(pool) - per_call
    if per_call - span < planted:
        raise ValueError(f"fewer than {planted} pool rows lie in every call")
    rows = span + torch.randperm(per_call - span, generator=gen, device=gen.device)[:planted]
    g2 = genes.view(count, length)
    upto = int(count * share)
    for j in range(planted):
        end = min(length, j + pool.shape[1])
        g2[j:upto:planted, j:end] = pool[rows[j], :end - j]


def make_cell_data(genes_spec: dict, read_length: int, traffic: dict, seed: int, device):
    """(genes on the device, gene_start (G+1,) int64 numpy, the read pool
    as host uint8 codes (P, read_length) sorted and distinct)."""
    gen = generator(seed, device)
    count, length = int(genes_spec["count"]), int(genes_spec["length"])
    genes = make_genes(count, length, gen)
    pool = make_reads(genes, count, length, read_length,
                      int(traffic["reads_per_call"]) + int(traffic["shift_span"]),
                      frac_random=float(traffic["frac_random"]),
                      sub_rate=float(traffic["sub_rate"]), gen=gen)
    pool = sort_unique(pool)
    if int(traffic.get("planted", 0)):
        plant(genes, count, length, pool, int(traffic["reads_per_call"]),
              int(traffic["planted"]), float(traffic["planted_genes"]), gen)
    gene_start = np.arange(count + 1, dtype=np.int64) * length
    return genes, gene_start, pool.cpu().numpy()


def call_offsets(seed: int, pool_rows: int, per_call: int, stream: int = 1):
    """The first pool row of each call's reads, an endless stream drawn
    from the seed (``stream`` tells warm-up from window): every call takes
    ``per_call`` consecutive rows."""
    rng = np.random.default_rng([int(seed), stream])
    span = pool_rows - per_call
    if span < 0:
        raise ValueError(f"the pool holds {pool_rows} distinct reads, fewer than the "
                         f"{per_call} a call takes")
    while True:
        yield int(rng.integers(0, span + 1))
