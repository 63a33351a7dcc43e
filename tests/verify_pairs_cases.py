"""Seeded inputs of the streaming expand's per-pair verify
(``verify_pairs_packed``, B10), shared by the tests that hold the port's
twin against the JAX package on the CPU (test_torch_streaming.py) and the
tests that hold the CUDA kernel against its twin on the card
(test_torch_verify_pairs_cuda.py).  It imports nothing of JAX, so the card
tests run where JAX is not installed."""

import numpy as np
import torch

from muscato_tpu_torch.ops import packed as tpacked
from muscato_tpu_torch.ops import verify as tverify

# name: (seed, width, window offsets, read words, read lengths, X rate,
# options).  Options: "scalar" gives every lane the first offset as one
# int; "rshift" fixes the in-word shift 4 * ((p - q1) & 7) of every lane
# that pair_inputs does not place at an edge; the rest place lanes at the
# edges of the kernel's tiles and warps: "lanes" keeps the last that many
# lanes (a lane count that is no multiple of a tile, or less than a warp),
# "dead_warps" makes whole warps dead (r = -1, p = -1, or half of each),
# "shared_rows" gives runs of lanes, whole warps among them, one read row.
# "0" and "1" are two seeds of one shape: width 12, reads up to 160 bases,
# no X codes.
CASES = {
    "0": (40, 12, (0, 10, 33, 60), 20, (22, 160), 0.0, {}),
    "1": (41, 12, (0, 10, 33, 60), 20, (22, 160), 0.0, {}),
    "w20-4win-13words": (2, 20, (0, 10, 30, 50), 13, (20, 104), 0.02, {}),
    "w20-scalar-q1": (3, 20, (0,), 13, (20, 104), 0.02, {"scalar": True}),
    "w20-scalar-q1-10": (4, 20, (10,), 13, (30, 104), 0.02, {"scalar": True}),
    "w8-1win-4words": (5, 8, (0,), 4, (10, 32), 0.01, {}),
    "w40-4win-19words": (6, 40, (0, 40, 80, 110), 19, (20, 152), 0.05, {}),
    "w8-32win-10words": (7, 8, tuple(range(0, 64, 2)), 10, (40, 80), 0.03, {}),
    "rshift-0": (8, 20, (0, 10, 30, 50), 13, (20, 104), 0.02, {"rshift": 0}),
    "rshift-28": (9, 20, (0, 10, 30, 50), 13, (20, 104), 0.02, {"rshift": 28}),
    "w20-2win-512words": (10, 20, (0, 100), 512, (20, 4096), 0.02, {}),
    "w20-1971-lanes": (11, 20, (0, 10, 30, 50), 13, (20, 104), 0.02, {"lanes": 1971}),
    "w20-19-lanes": (12, 20, (0, 10, 30, 50), 13, (20, 104), 0.02, {"lanes": 19}),
    "w20-dead-warps": (13, 20, (0, 10, 30, 50), 13, (20, 104), 0.02, {"dead_warps": True}),
    "w20-shared-rows": (14, 20, (0, 10, 30, 50), 13, (20, 104), 0.02, {"shared_rows": True}),
    "w20-512words-tile-edges": (15, 20, (0, 100), 512, (20, 600), 0.02,
                                {"lanes": 2003, "dead_warps": True}),
}


def as_tensor(a) -> torch.Tensor:
    a = np.array(a)  # a writable copy (jax arrays are read-only)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def pair_inputs(name, n=2048, nreads=160, s=7000, ngenes=12):
    """One case's lanes as the streaming chunk feeds them: pairs in random
    order, each with a window offset q1 of the case's set (or one scalar),
    over irregular genes with X codes in reads and targets; 5% of lanes
    inactive by r = -1 and 5% by p = -1; window positions before their
    read's start in the gene and before the stream's start (negative
    diagonals); an eighth of the lanes planted (the read is the target
    under its diagonal, with 0-3 substitutions); reads longer than 100 and
    reads within the pos-0 cap, each at gene starts with q1 = 0 (the
    reference's pos-0 quirk); lanes in the last gene, at the last stream
    position and past it (clamped); then the case's tile-edge options.
    Reads hold random codes past their length.  Returns a dict of numpy
    arrays and ints."""
    seed, width, q1s, nwords, (lo, hi), x_rate, opts = CASES[name]
    rng = np.random.default_rng(seed)
    max_rl = 8 * nwords
    cuts = np.sort(rng.choice(np.arange(1, s), ngenes - 1, replace=False))
    gene_start = np.concatenate([[0], cuts, [s]]).astype(np.int32)
    tcat = rng.integers(0, 4, s).astype(np.uint8)
    tcat[rng.random(s) < x_rate] = 4
    codes = rng.integers(0, 4, (nreads, max_rl)).astype(np.uint8)
    codes[rng.random(codes.shape) < x_rate] = 4
    lengths = rng.integers(lo, hi + 1, nreads).astype(np.int32)
    if max_rl > 100:
        lengths[:8] = rng.integers(101, max_rl + 1, 8)  # longer than 100
    lengths[8:16] = rng.integers(lo, min(hi, 100 - width) + 1, 8)  # within the pos-0 cap

    scalar = opts.get("scalar", False)
    q1 = np.asarray(q1s, np.int32)[rng.integers(0, len(q1s), n)]
    r = rng.integers(16, nreads, n).astype(np.int32)
    p = rng.integers(0, s, n).astype(np.int32)
    if "rshift" in opts:
        d = np.maximum(p - q1, 0)
        p = np.minimum((d & ~7) + opts["rshift"] // 4 + q1, s - 1).astype(np.int32)
    # Window positions just past a gene start (the read would start before
    # the gene) and near the stream's start (negative diagonals).
    near = rng.random(n) < 0.05
    p[near] = gene_start[rng.integers(0, ngenes, near.sum())] + rng.integers(0, 40, near.sum())
    neg = rng.random(n) < 0.05
    p[neg] = rng.integers(0, 40, neg.sum())
    # Planted pairs, each on a read of its own.
    planted = rng.choice(n - 64, n // 8, replace=False)
    for i, rr in zip(planted, rng.permutation(np.arange(16, nreads))):
        d = p[i] - q1[i]
        if d >= 0:
            seg = tcat[d: d + max_rl].copy()
            at = rng.integers(0, len(seg), rng.integers(0, 4))
            seg[at] = (seg[at] + 1) % 5
            r[i] = rr
            codes[rr, : len(seg)] = seg
    r[rng.random(n) < 0.05] = -1
    p[rng.random(n) < 0.05] = -1
    # The pos-0 quirk: q1 == 0 at gene starts, on the reads longer than 100
    # (the cap rejects them) and on those within it, each the target there.
    for j, i in enumerate(range(n - 24, n)):
        rr = j % 16
        p[i], q1[i], r[i] = gene_start[j % ngenes], 0, rr
        seg = tcat[p[i]: p[i] + lengths[rr]]
        codes[rr, : len(seg)] = seg
    p[n - 40: n - 24] = rng.integers(gene_start[-2], s, 16)  # the last gene
    p[n - 44: n - 40] = s - 1  # the last stream position
    p[n - 46: n - 44] = s + 3  # past it: clamped to the last
    if "lanes" in opts:
        keep = slice(max(n - opts["lanes"], 0), n)
        r, p, q1 = r[keep], p[keep], q1[keep]
    if opts.get("dead_warps"):
        r[96:128] = -1
        p[160:192] = -1
        r[224:240] = -1
        p[240:256] = -1
    if opts.get("shared_rows"):
        # Runs of 32 (whole warps, then one across two warps) and of 5.
        for a, b, run in ((256, 352, 32), (368, 400, 32), (512, 640, 5)):
            for j in range(a, min(b, len(r)), run):
                r[j: min(j + run, b)] = r[j]
    if scalar:
        q1 = int(q1s[0])
    budget = tverify.mismatch_budget_table(0.9, max_rl)
    return dict(r=r, p=p, q1=q1, codes=codes, lengths=lengths, tcat=tcat,
                gene_start=gene_start, budget=budget, s=s, width=width, max_rl=max_rl,
                nwords=nwords)


def pair_args(name, **kw):
    """The wrapper's arguments on the CPU for ``pair_inputs``' lanes:
    (r, p, rpacked, lengths, gene_start, budget, q1, width,
    max_read_length, smax, trows, gblock, gsteps), and the packed stream
    (numpy uint32) that the JAX function also takes."""
    c = pair_inputs(name, **kw)
    s = c["s"]
    rpacked = tpacked.pack_rows(torch.from_numpy(c["codes"]))
    tp = tpacked.pack_stream(c["tcat"])
    trows = tpacked.build_trows(as_tensor(tp), c["nwords"], s)
    gb, steps = tpacked.build_gene_block(c["gene_start"], s)
    q1 = c["q1"] if isinstance(c["q1"], int) else as_tensor(c["q1"])
    return (as_tensor(c["r"]), as_tensor(c["p"]), rpacked, as_tensor(c["lengths"]),
            as_tensor(c["gene_start"]), as_tensor(c["budget"]), q1, c["width"],
            c["max_rl"], s, trows, as_tensor(gb), steps), tp
