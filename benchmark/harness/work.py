"""The work one call of a kernel's function needs, and the least time the
card could take for it: a frozen copy of ``chip_smoke.py``'s ``call_work``,
``binary_replay``, ``join_replay``, ``packed_keys`` and ``bounds``, with
the port's helpers they import (``search.bucket_of``,
``packed.gene_of_pos_block``, ``windows.uses_second_key``, ``join.flip``,
``packed.u64``) copied beside them, so that the yardstick does not move
when the program does.  The work is reckoned from each function's inputs,
so it is the same whatever kernel implements the function.

Bytes count each input read once and each output written once, over the
card's published memory rate; integer operations count what the function
does, over SMs x 64 lanes x the card's maximum SM clock.
"""

from __future__ import annotations

import functools
import subprocess

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM peak memory rate (NVIDIA data sheet)
# 32-bit integer results a clock on one SM, for each of its two integer
# pipes (the arithmetic throughput table for compute capability 9.0 in
# NVIDIA's CUDA C++ programming documentation).
INT_LANES_PER_SM = 64
JOIN_TILE = 512  # B1's queries a CTA (kJoinTile in the port's csrc/join.cu)
M32 = 0xFFFFFFFF
GENE_BLOCK_BITS = 8  # the port's gene block table: one entry per 256 positions
EXACT_WIDTH_LIMIT = 13  # wider windows pair their key with a second hash
_SIGN = -(1 << 31)


def u64(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2**32)."""
    return x.to(torch.int64) & M32


def flip(u: torch.Tensor) -> torch.Tensor:
    """uint32 bit patterns held as int32 -> int32 whose signed order is the
    unsigned order of the patterns."""
    return u ^ _SIGN


def uses_second_key(width: int) -> bool:
    return width > EXACT_WIDTH_LIMIT


def bucket_of(key: torch.Tensor, upshift: int, bucket_bits: int = 16) -> torch.Tensor:
    """The top ``bucket_bits`` of the uint32 ``key << upshift``, as int64."""
    return ((u64(key) << upshift) & M32) >> (32 - bucket_bits)


def gene_of_pos_block(gene_start, gblock, p, steps: int):
    """Owning gene of each position: bounds from two adjacent gblock
    entries, then ``steps`` branchless refines."""
    g = gene_start.shape[0] - 1
    nb = gblock.shape[0]
    b = p >> GENE_BLOCK_BITS
    lo = gblock[b.clamp(0, nb - 1).long()]
    hi = gblock[(b + 1).clamp(0, nb - 1).long()]
    for _ in range(steps):
        mid = (lo + hi + 1) >> 1
        up = gene_start[mid.clamp(0, g).long()] <= p
        lo = torch.where(up, mid, lo)
        hi = torch.where(up, hi, mid - 1)
    return lo


@functools.lru_cache(maxsize=None)
def int_pipe_rate() -> float:
    """Peak 32-bit integer operations a second of one pipe of this card:
    SMs x INT_LANES_PER_SM x the maximum SM clock nvidia-smi reports."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.split()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT_LANES_PER_SM * float(mhz) * 1e6


def call_work(kernel: str, args, kw) -> tuple:
    """(bytes, multiply-adds, other integer operations) that one call of a
    kernel's function needs, from its inputs alone.  Bytes: each input
    read once and each output written once; table entries, rows and slots
    count once however often they are fetched, and only those this call's
    data touches.  Operations: what the function does, whatever the
    kernel:
      sorted_join       B1's searches replayed on this call's data
                        (join_replay): a subtract, a shift, an add, a
                        compare and two selects a read of the index.  Its
                        bytes: the distinct 32-byte sectors of the index
                        those searches read, the queries and the two
                        outputs;
      expand_owners     a compare a slot that owns lanes; a compare and two
                        adds a lane;
      monotone_gather   the clamp's two compares a lane (B4: a row);
      window_queries    a base: a nibble extract, a multiply-add a key,
                        and for the dinucleotide mask a multiply-add, a
                        shift and an or; a popcount and two compares a
                        (window, read);
      verify_diagonals_swar  a word: a funnel shift, an xor, the length
                        mask, three shift-ors, an and, a popcount and an
                        add; an and, a popcount and an add a (window,
                        word); six compares and selects a (window, lane)
                        and ten a lane.  Its bytes: (r, d), the lane's
                        nwords + 1 target words, gstart and gend, the
                        three outputs, and each read row and length the
                        lanes touch, once.
      verify_pairs      B7's work a word with one window, four a refine
                        step of the gene lookup, thirty a lane.  Its
                        bytes: (r, p), q1 where it is one a lane, the
                        lane's nwords + 1 target words, the four outputs,
                        each read row the lanes touch and each gblock and
                        gene_start entry of their genes, once.
      direct_probe      a query: its bucket (two shifts), the validity
                        select; a record of its bucket: a compare a key
                        word and an add.  Its bytes: the queries, the
                        bucket bounds and the records of each distinct
                        bucket the queries touch, once, the two outputs;
      binary_probe      a round of a query's search (binary_replay): an
                        add, a shift, two compares and two selects; the
                        hit test's four compares.  Its bytes: the queries,
                        the distinct bucket bounds, the distinct key pairs
                        the searches and hit tests read, a count and start
                        a distinct hit, the two outputs.
    """
    if kernel in ("direct_probe", "binary_probe"):
        keyf, key2f, validf, *tables = args
        q, k2 = keyf.numel(), int(kw["use_k2"])
        sbucket = tables[-1]
        b = bucket_of(keyf, kw["upshift"], kw["bucket_bits"])
        ub = torch.unique(b)
        fixed = q * (5 + 4 * k2 + 8) + 4 * torch.unique(torch.cat([ub, ub + 1])).numel()
        if kernel == "direct_probe":
            w = kw["bucket_width"]
            span = lambda x: (sbucket[x + 1] - sbucket[x]).clamp(0, w).long()  # noqa: E731
            return fixed + 16 * int(span(ub).sum()), 0, 3 * q + (2 + k2) * int(span(b).sum())
        read, hits, rounds = binary_replay(args, kw)
        return (fixed + 8 * torch.unique(read).numel() + 8 * torch.unique(hits).numel(), 0,
                6 * rounds + 4 * q)

    if kernel == "verify_pairs":
        r, p, rpacked, lengths, gene_start, budget, q1 = args[:7]
        smax, trows, gblock, gsteps = args[9:13]
        c, (nreads, nw) = r.numel(), rpacked.shape
        pc = p.clamp(0, smax - 1)
        g = gene_of_pos_block(gene_start, gblock, pc, gsteps)
        b = pc >> GENE_BLOCK_BITS
        uniq = lambda *xs, hi: torch.unique(torch.cat(xs).clamp(0, hi)).numel()  # noqa: E731
        entries = (uniq(b, b + 1, hi=gblock.numel() - 1)
                   + uniq(g, g + 1, hi=gene_start.numel() - 1))
        rows = torch.unique(r.clamp(0, nreads - 1)).numel()
        lane = 8 + 4 * int(torch.is_tensor(q1) and q1.numel() > 1) + 4 * (nw + 1) + 13
        return (c * lane + rows * 4 * (nw + 1) + 4 * entries + 4 * budget.numel(),
                0, c * (nw * 14 + 4 * gsteps + 30))

    if kernel == "verify_diagonals_swar":
        r, _, _, rpacked, _, _, _, budget, q1s = args
        c, (nreads, nw), k = r.numel(), rpacked.shape, len(q1s)
        rows = torch.unique(r.clamp(0, nreads - 1)).numel()
        return (c * (8 + 4 * (nw + 1) + 8 + 12) + rows * 4 * (nw + 1) + 4 * budget.numel(),
                0, c * (nw * (11 + 3 * k) + 6 * k + 10))

    if kernel == "window_queries":
        r, nw = args[0].shape
        k, width, dinuc = len(args[2]), kw["width"], int(kw["min_dinuc"] > 0)
        bases = r * k * width
        return (4 * r * (nw + 1) + 9 * k * r,
                bases * (1 + int(uses_second_key(width)) + dinuc),
                bases * (1 + 2 * dinuc) + 3 * k * r)
    if kernel == "sorted_join":
        sectors, reads = join_replay(*args)
        return 32 * sectors + 12 * args[1].numel(), 0, 6 * reads
    if kernel.startswith("expand_owners"):
        # The slots that own lanes have distinct oexcl values.
        owners, cap = torch.unique(args[0]).numel(), kw["pair_cap"]
        return 12 * owners + 8 * cap, 0, owners + 3 * cap
    table, idx = args
    m = idx.numel()
    touched = torch.unique(idx.clamp(0, table.shape[0] - 1)).numel()
    row = 4 * (table.shape[1] if table.dim() == 2 else 1)  # bytes an entry
    return row * (touched + m) + 4 * m, 0, 2 * m


def binary_replay(args, kw) -> tuple:
    """B9's searches replayed on one call's data: (the key-pair indices
    they read, the rounds and the hit test included; the indices of the
    hits; the rounds run, each ending once lo == hi)."""
    keyf, key2f, validf, ukeys, ukeys2, *_, sbucket = args
    n = ukeys.numel()
    key = packed_keys(keyf, key2f, kw["use_k2"])
    ent = lambda at: packed_keys(ukeys[at], ukeys2[at], kw["use_k2"])  # noqa: E731
    b = bucket_of(keyf, kw["upshift"], kw["bucket_bits"])
    lo, hi = sbucket[b].long(), sbucket[b + 1].long()
    read, rounds = [], 0
    for _ in range(kw["probe_steps"]):
        act = lo < hi
        mid = (lo + hi) >> 1
        read.append(mid[act])
        rounds += int(act.sum())
        right = act & (ent(mid.clamp(max=n - 1)) < key)
        lo = torch.where(right, mid + 1, lo)
        hi = torch.where(act & ~right, mid, hi)
    at = lo.clamp(max=n - 1)
    hit = validf & (lo < n) & (ent(at) == key)
    return torch.cat(read + [at]), at[hit], rounds


def join_replay(skeys, qkeys) -> tuple:
    """B1's searches replayed on one call's data: each tile of JOIN_TILE
    queries finds L = lower_bound(its min) and H = upper_bound(its max) by
    a warp's 32-ary search of the whole index, then each query its lower
    bound by bisection of [L, H) and its upper bound by galloping from
    there, then bisection.  Raises if the bounds it finds are not those of
    ``torch.searchsorted``.  Returns (the distinct 32-byte sectors of the
    index those searches read, the reads they make)."""
    k, q = flip(skeys), flip(qkeys)  # signed order: the keys' unsigned order
    v, m, dev = k.numel(), q.numel(), k.device
    head = skeys.data_ptr() % 32 // 4  # the index's first word in its sector
    touched = torch.zeros((head + v + 7) // 8, dtype=torch.bool, device=dev)
    reads = 0

    def read(at):
        nonlocal reads
        touched[(at + head) >> 3] = True
        reads += at.numel()
        return k[at]

    t = -(-m // JOIN_TILE)
    tiles = lambda fill: torch.cat([q, q.new_full((t * JOIN_TILE - m,), fill)]).view(t, -1)  # noqa: E731
    x = torch.cat([tiles(2**31 - 1).amin(1), tiles(-2**31).amax(1)])[:, None]
    strict = (torch.arange(2 * t, device=dev) >= t)[:, None]
    above = lambda kv, x, strict: torch.where(strict, kv > x, kv >= x)  # noqa: E731
    lo = torch.zeros(2 * t, dtype=torch.int64, device=dev)
    hi = torch.full_like(lo, v)
    lanes = torch.arange(1, 32, device=dev)
    while bool(((hi - lo) > 32).any()):
        act = (hi - lo) > 32
        a, b = lo[act], hi[act]
        piv = torch.cat([a[:, None] + (b - a)[:, None] * lanes // 32, b[:, None]], 1)
        hit = torch.ones(piv.shape, dtype=torch.bool, device=dev)  # lane 31: hi
        hit[:, :31] = above(read(piv[:, :31].flatten()).view(-1, 31), x[act], strict[act])
        first = hit.to(torch.int32).argmax(1)[:, None]
        lo[act] = torch.where(first[:, 0] > 0, piv.gather(1, (first - 1).clamp(min=0))[:, 0] + 1, a)
        hi[act] = piv.gather(1, first)[:, 0]
    at = lo[:, None] + torch.arange(32, device=dev)
    inside = at < hi[:, None]
    hit = torch.zeros(at.shape, dtype=torch.bool, device=dev)
    hit[inside] = above(read(at[inside]), x.expand(at.shape)[inside],
                        strict.expand(at.shape)[inside])
    bound = torch.where(hit.any(1), lo + hit.to(torch.int32).argmax(1), hi)
    tile = torch.arange(m, device=dev) // JOIN_TILE
    top = bound[t:][tile]

    def bisect(lo, hi, right_of):
        while bool((lo < hi).any()):
            act = lo < hi
            mid = lo + ((hi - lo) >> 1)
            right = torch.zeros_like(act)
            right[act] = right_of(read(mid[act]), q[act])
            lo, hi = torch.where(right, mid + 1, lo), torch.where(act & ~right, mid, hi)
        return lo

    first = bisect(bound[:t][tile], top, lambda kv, qv: kv < qv)
    lo, hi, gal, step = first, top, first < top, 1
    while bool(gal.any()):
        probe = lo + step - 1
        gal &= probe < hi
        over = torch.zeros_like(gal)
        over[gal] = read(probe[gal]) > q[gal]
        hi = torch.where(over, probe, hi)
        lo = torch.where(gal & ~over, probe + 1, lo)
        gal &= ~over & (lo < hi)
        step <<= 1
    last = bisect(lo, hi, lambda kv, qv: kv <= qv)
    if not (torch.equal(first, torch.searchsorted(k, q, side="left"))
            and torch.equal(last, torch.searchsorted(k, q, side="right"))):
        raise RuntimeError("join_replay: the replayed searches' bounds differ from "
                           "torch.searchsorted's")
    return int(touched.sum()), reads


def packed_keys(k1, k2, use_k2):
    """(key1, key2) int32 bit patterns as one int64 whose signed order is
    the pairs' unsigned order (key2 left out where the width has none)."""
    key = flip(k1).long() << 32
    return key | u64(k2) if use_k2 else key


def bounds(work, int_rate=None) -> dict:
    """The least time the card could take for ``work`` (call_work): the
    larger of its bytes over the peak memory rate and its integer
    operations over the peak rate of the pipe that has more of them."""
    nbytes, mads, alus = work
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = max(mads, alus) / (int_rate or int_pipe_rate()) * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                bytes_bound_ms=by_bytes, ops_bound_ms=by_ops)
