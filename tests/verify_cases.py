"""Seeded inputs of the dedup verify's SWAR body (B7), shared by the tests
that hold the port against the JAX package on the CPU
(test_torch_verify_kernel.py) and the tests that hold the CUDA kernel
against its twin on the card (test_torch_verify_cuda.py).  It imports
nothing of JAX, so the card tests run where JAX is not installed."""

import numpy as np
import torch

from muscato_tpu_torch.ops import packed as tpacked
from muscato_tpu_torch.ops import verify as tverify

# (width, window offsets, read words, read lengths, X rate)
CASES = {
    "w8-1win-4words": (8, (0,), 4, (20, 32), 0.01),
    "w20-4win-13words": (20, (10, 30, 50, 70), 13, (20, 104), 0.02),
    "w40-4win-19words": (40, (0, 40, 80, 110), 19, (20, 150), 0.05),
    "w8-31win-10words": (8, tuple(range(0, 62, 2)), 10, (40, 80), 0.03),
    "w20-past-width-13words": (20, (0, 20, 100, 130), 13, (90, 104), 0.01),
    "w40-1win-18words": (40, (0,), 18, (20, 144), 0.04),
}


def as_tensor(a) -> torch.Tensor:
    a = np.array(a)  # a writable copy (jax arrays are read-only)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def lane_inputs(seed, nwords, lengths, x_rate, n=768, nreads=200, s=6000, ndead=None):
    """Lanes sorted by diagonal as the engine feeds a verify chunk:
    negative diagonals in front, a dead tail (r = -1, d = 0, the chunk's
    padding), lanes at gene starts (the pos-0 quirk) and at the last
    stream position, and a quarter of the live lanes planted (the target
    under the diagonal with 0-3 substitutions), over irregular genes with
    X codes in reads and targets."""
    rng = np.random.default_rng(seed)
    max_rl = 8 * nwords
    cuts = np.sort(rng.choice(np.arange(1, s), 12, replace=False))
    gene_start = np.concatenate([[0], cuts, [s]]).astype(np.int32)
    tcat = rng.integers(0, 4, s).astype(np.uint8)
    tcat[rng.random(s) < x_rate] = 4
    codes = rng.integers(0, 4, (nreads, max_rl)).astype(np.uint8)
    codes[rng.random(codes.shape) < x_rate] = 4
    lens = rng.integers(lengths[0], lengths[1] + 1, nreads).astype(np.int32)
    ndead = n // 12 if ndead is None else ndead
    d = rng.integers(0, s, n - ndead)
    d[:40] = rng.choice(gene_start[:-1], 40)
    d[40:44] = s - 1
    d = np.sort(d).astype(np.int32)
    d[:5] = [-9, -4, -4, -1, 0]
    r = rng.integers(0, nreads, n - ndead).astype(np.int32)
    live = np.flatnonzero(d >= 0)
    planted = rng.choice(live, nreads // 2, replace=False)
    r[planted] = rng.permutation(nreads)[: len(planted)]
    for i in planted:
        seg = tcat[d[i]: d[i] + max_rl].copy()
        at = rng.integers(0, len(seg), rng.integers(0, 4))
        seg[at] = (seg[at] + 1) % 5
        codes[r[i], : len(seg)] = seg
    codes[np.arange(max_rl)[None, :] >= lens[:, None]] = 0
    r = np.concatenate([r, np.full(ndead, -1, np.int32)])
    d = np.concatenate([d, np.zeros(ndead, np.int32)])
    budget = tverify.mismatch_budget_table(0.9, max_rl)
    return r, d, codes, lens, tcat, gene_start, budget, s


def swar_args(seed, nwords, lengths, x_rate, q1s, n=768, ndead=None, tile_read=False,
              widen=0):
    """The SWAR body's arguments on the CPU for lane_inputs' lanes
    (fetched by ``diagonal_fetch``): ``ndead`` dead tail lanes (default n
    // 12), with ``tile_read`` every run of 256 live lanes (B7's widest
    tile, a multiple of every narrower one) on its first lane's read, and
    t_rows padded with ``widen`` columns."""
    r, d, codes, lens, tcat, gene_start, budget, s = lane_inputs(
        seed, nwords, lengths, x_rate, n=n, ndead=ndead)
    if tile_read:
        live = r >= 0
        r[live] = r[np.arange(len(r)) // 256 * 256][live]
    rp = tpacked.pack_rows(torch.from_numpy(codes))
    trows = tpacked.build_trows(as_tensor(tpacked.pack_stream(tcat)), nwords, s)
    gb, steps = tpacked.build_gene_block(gene_start, s)
    _, gstart, gend, t_rows = tpacked.diagonal_fetch(
        as_tensor(r), as_tensor(d), as_tensor(gene_start), as_tensor(gb), steps, trows, s)
    t_rows = torch.nn.functional.pad(t_rows, (0, widen))
    return (as_tensor(r), as_tensor(d), t_rows, rp, as_tensor(lens), gstart, gend,
            as_tensor(budget), q1s), s
