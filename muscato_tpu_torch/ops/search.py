"""Bucketed binary search over composite 64-bit keys (port of
``muscato_tpu/ops/search.py``).

The target index for window widths > 13 uses a (key1, key2) pair of 32-bit
hashes, so the search probe compares both words.  The search is an unrolled
branchless binary search (its trip count fixed by the index), two gathers a
step, starting from the bounds of the query's bucket.

Keys are int32 tensors holding uint32 bit patterns, as everywhere in the
port: they are compared through ``join.flip`` (signed order of the flipped
patterns is the unsigned order), and the bucket index is computed on int64
copies masked to 32 bits, since ``>>`` on ``torch.uint32`` raises on the CPU.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import windows as winops
from .join import flip
from .packed import M32, u64


def bucket_shift(width: int) -> int:
    """Monotone scaling that spreads this width's key range over the 16-bit
    bucket space: bucket_of(key) = (key << upshift) >> 16."""
    if winops.uses_second_key(width):
        bits = 32
    else:
        bits = max(1, math.ceil(width * math.log2(winops.NBASE)))
    return max(0, 32 - max(bits, 16))


def bucket_of(key: torch.Tensor, upshift: int, bucket_bits: int = 16) -> torch.Tensor:
    """The bucket of each key: the top ``bucket_bits`` of the uint32
    ``key << upshift`` (bits shifted past 32 are lost), as int64."""
    return ((u64(key) << upshift) & M32) >> (32 - bucket_bits)


MAX_BUCKET_BITS = 22  # 16MB table cap


def bucket_bits_for(n_entries: int) -> int:
    """Bucket-table size targeting ~16 entries per bucket."""
    bits = max(16, (max(n_entries, 1) // 16).bit_length())
    return min(bits, MAX_BUCKET_BITS)


def build_buckets_host(k1_sorted, upshift: int, bucket_bits: int | None = None):
    """Host-side bucket table: bucket[b] = first index whose scaled key is
    in bucket b.  Returns (bucket (2**bits+1,) int32, probe_steps int,
    bucket_bits int)."""
    if bucket_bits is None:
        bucket_bits = bucket_bits_for(len(k1_sorted))
    nb = 1 << bucket_bits
    scaled = (
        (k1_sorted.astype(np.uint64) << np.uint64(upshift))
        >> np.uint64(32 - bucket_bits)
    ).astype(np.int64)
    bucket = np.searchsorted(scaled, np.arange(nb + 1, dtype=np.int64)).astype(
        np.int32
    )
    max_run = int(np.max(np.diff(bucket))) if len(k1_sorted) else 1
    steps = max(1, int(max_run).bit_length())
    return bucket, steps, bucket_bits


def _search(fetch, k1, k2, lo, hi, n: int, steps: int, use_k2: bool, right=False):
    """``steps`` rounds of the branchless binary search of (k1, k2) in
    [lo, hi); ``fetch(mid)`` gives the entry's (m1, m2) at the clamped
    midpoints.  Keys compare as uint32 through their flipped patterns."""
    f1 = flip(k1)
    f2 = flip(k2) if use_k2 else None
    for _ in range(steps):
        mid = (lo + hi) >> 1
        m1, m2 = fetch(mid.clamp(max=n - 1))
        m1 = flip(m1)
        if use_k2:
            m2 = flip(m2)
            below = (m2 <= f2) if right else (m2 < f2)
            go_right = (m1 < f1) | ((m1 == f1) & below)
        else:
            go_right = m1 < f1
        go_right = go_right & (mid < hi)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, torch.minimum(hi, mid))
    return lo


def searchsorted2_bucketed(a1, a2, k1, k2, bucket, *, upshift: int, steps: int,
                           use_k2: bool, bucket_bits: int = 16, interleaved=None):
    """'left' insertion points (int64) of the (k1, k2) queries into the
    sorted (a1, a2) entries, starting from per-bucket bounds.  ``steps``
    must cover the largest bucket (log2 of its size); the index build
    computes it, so the search is exact by construction.  ``interleaved``,
    (2N,) [a1_0, a2_0, a1_1, ...], puts both key words of an entry at
    adjacent addresses, so that a step's two gathers share a line."""
    n = a1.shape[0]
    b = bucket_of(k1, upshift, bucket_bits)
    lo = bucket[b].to(torch.int64)
    hi = bucket[b + 1].to(torch.int64)
    if use_k2 and interleaved is not None:
        def fetch(m):
            return interleaved[m * 2], interleaved[m * 2 + 1]
    else:
        def fetch(m):
            return a1[m], (a2[m] if use_k2 else None)
    return _search(fetch, k1, k2, lo, hi, n, steps, use_k2)


def searchsorted2(a1, a2, k1, k2, side: str = "left"):
    """Insertion points (int64) of (k1, k2) into the sorted (a1, a2)
    sequence, both compared as uint32."""
    n = a1.shape[0]
    lo = torch.zeros(k1.shape, dtype=torch.int64, device=k1.device)
    hi = torch.full(k1.shape, n, dtype=torch.int64, device=k1.device)
    steps = max(1, n).bit_length()
    return _search(lambda m: (a1[m], a2[m]), k1, k2, lo, hi, n, steps, True,
                   right=side != "left")
