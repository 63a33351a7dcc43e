"""Bucketed binary search over composite 64-bit keys (port of
``muscato_tpu/ops/search.py``), and the search probe's two bodies as
kernels: ``direct_probe`` (B8) and ``binary_probe`` (B9) launch
``csrc/probe.cu`` on CUDA tensors; ``direct_probe_torch`` and
``binary_probe_torch``, their plain twins, run for CPU tensors.

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

from . import _lib
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


DIRECT_CHUNK = 1 << 20  # queries a chunk of the direct twin's record fetch


def direct_probe_torch(keyf, key2f, validf, urec, sbucket, *, upshift: int,
                       bucket_bits: int, bucket_width: int, use_k2: bool):
    """Plain twin of ``direct_probe``.  The queries run in chunks of
    DIRECT_CHUNK, which bounds the (C, w, 4) record fetch, as the JAX
    function's ``lax.map`` does."""
    nflat = keyf.shape[0]
    dev = keyf.device
    w = bucket_width
    recs = urec.view(-1, 4)  # 16-byte records
    lane = torch.arange(w, dtype=torch.int64, device=dev)
    counts = torch.zeros(nflat, dtype=torch.int32, device=dev)
    loc = torch.zeros(nflat, dtype=torch.int32, device=dev)
    for c0 in range(0, nflat, DIRECT_CHUNK):
        keyc = keyf[c0 : c0 + DIRECT_CHUNK]
        b = bucket_of(keyc, upshift, bucket_bits)
        lo = sbucket[b].to(torch.int64)
        nb = sbucket[b + 1].to(torch.int64) - lo
        rec = recs[lo[:, None] + lane[None, :]]  # (C, w, 4)
        hit_j = (lane[None, :] < nb[:, None]) & (rec[:, :, 0] == keyc[:, None])
        if use_k2:
            hit_j = hit_j & (rec[:, :, 1] == key2f[c0 : c0 + DIRECT_CHUNK, None])
        hit = validf[c0 : c0 + DIRECT_CHUNK] & hit_j.any(dim=1)
        c = torch.where(hit_j, rec[:, :, 3], 0).sum(dim=1, dtype=torch.int32)
        counts[c0 : c0 + DIRECT_CHUNK] = torch.where(hit, c, 0)
        loc[c0 : c0 + DIRECT_CHUNK] = torch.where(hit_j, rec[:, :, 2], 0).sum(
            dim=1, dtype=torch.int32)
    return counts, loc


def _query_tensors(name, keyf, key2f, validf, *tables, bucket_bits, columns=()) -> bool:
    """True for CPU tensors (the twin runs); for CUDA ones checks what the
    kernel takes: int32 keys and tables, a bool validity, one device,
    contiguous, equal query lengths, a bucket table (the last of
    ``tables``) of 2**bucket_bits + 1 bounds.  ``columns``, column views of
    a table, need only lie on the queries' device."""
    if (_lib.on_cpu(name, keyf, key2f, *tables) and validf.device.type == "cpu"
            and all(c.device.type == "cpu" for c in columns)):
        return True
    if validf.device != keyf.device or validf.dtype != torch.bool or not validf.is_contiguous():
        raise ValueError(f"{name}: validf must be a contiguous bool tensor on {keyf.device}")
    if any(c.device != keyf.device for c in columns):
        raise ValueError(f"{name}: every table must lie on {keyf.device}")
    if not keyf.shape[0] == key2f.shape[0] == validf.shape[0]:
        raise ValueError(f"{name}: query lengths disagree")
    if not 1 <= bucket_bits <= 31 or tables[-1].numel() != (1 << bucket_bits) + 1:
        raise ValueError(f"{name}: sbucket must hold 2**bucket_bits + 1 bounds")
    return False


def _outputs(keyf):
    return tuple(torch.empty(keyf.shape[0], dtype=torch.int32, device=keyf.device)
                 for _ in range(2))


def _launch_direct(keyf, key2f, validf, urec, sbucket, *, upshift: int, bucket_bits: int,
                   bucket_width: int, use_k2: bool, lib=None):
    """B8's launch on checked CUDA tensors, from ``lib`` (a library of
    another build of csrc/probe.cu; default: the kernel library); counts
    nothing.  Returns (counts, loc)."""
    counts, loc = _outputs(keyf)
    _lib.launch("direct_probe", keyf, keyf.data_ptr(), key2f.data_ptr(), validf.data_ptr(),
                keyf.shape[0], urec.data_ptr(), sbucket.data_ptr(), upshift, bucket_bits,
                bucket_width, int(use_k2), counts.data_ptr(), loc.data_ptr(), lib=lib)
    return counts, loc


def _launch_binary(keyf, key2f, validf, ukk, ustart, nuniq: int, sbucket, *, upshift: int,
                   bucket_bits: int, probe_steps: int, use_k2: bool, lib=None):
    """B9's launch on checked CUDA tensors (``ustart`` the first column of
    the (start, count) pairs), as ``_launch_direct``."""
    counts, loc = _outputs(keyf)
    _lib.launch("binary_probe", keyf, keyf.data_ptr(), key2f.data_ptr(), validf.data_ptr(),
                keyf.shape[0], ukk.data_ptr(), ustart.data_ptr(), nuniq, sbucket.data_ptr(),
                upshift, bucket_bits, probe_steps, int(use_k2), counts.data_ptr(),
                loc.data_ptr(), lib=lib)
    return counts, loc


def direct_probe(keyf, key2f, validf, urec, sbucket, *, upshift: int, bucket_bits: int,
                 bucket_width: int, use_k2: bool):
    """B8, the direct-bucket probe (the body of
    ``muscato_tpu/ops/fused.py:_probe_windows_direct_impl``): for each
    sorted query (``keyf``, ``key2f``, ``validf``) the bucket's bounds in
    ``sbucket``, then at most ``bucket_width`` of the bucket's (k1, k2,
    start, count) records in ``urec`` (flat int32, 16-byte records).
    Returns (counts, loc), (Q,) int32: the hit records' summed counts (0
    unless valid) and summed starts.  Launches ``csrc/probe.cu`` on CUDA
    tensors; raises where the launcher refuses (a ``bucket_width`` past
    its 16 records, ``urec`` not 16-byte aligned)."""
    kw = dict(upshift=upshift, bucket_bits=bucket_bits, bucket_width=bucket_width,
              use_k2=use_k2)
    if _query_tensors("direct_probe", keyf, key2f, validf, urec, sbucket,
                      bucket_bits=bucket_bits):
        return direct_probe_torch(keyf, key2f, validf, urec, sbucket, **kw)
    if not keyf.shape[0]:
        return _outputs(keyf)
    out = _launch_direct(keyf, key2f, validf, urec, sbucket, **kw)
    direct_probe.launches += 1
    return out


def binary_probe_torch(keyf, key2f, validf, ukeys, ukeys2, ukk, ustart, ucount, sbucket, *,
                       upshift: int, bucket_bits: int, probe_steps: int, use_k2: bool):
    """Plain twin of ``binary_probe``."""
    nuniq = ukeys.shape[0]
    lo_u = searchsorted2_bucketed(
        ukeys, ukeys2, keyf, key2f, sbucket, upshift=upshift, steps=probe_steps,
        use_k2=use_k2, bucket_bits=bucket_bits, interleaved=ukk,
    )
    loc = lo_u.clamp(max=nuniq - 1)
    eq = ukeys[loc] == keyf
    if use_k2:
        eq = eq & (ukeys2[loc] == key2f)
    hit = validf & eq & (lo_u < nuniq)
    counts = torch.where(hit, ucount[loc], 0)
    loc = torch.where(hit, ustart[loc], 0)
    return counts, loc


def binary_probe(keyf, key2f, validf, ukeys, ukeys2, ukk, ustart, ucount, sbucket, *,
                 upshift: int, bucket_bits: int, probe_steps: int, use_k2: bool):
    """B9, the bucketed binary search and hit test (the body of
    ``muscato_tpu/ops/fused.py:_probe_windows_search_impl``, with
    ``muscato_tpu/ops/search.py:searchsorted2_bucketed``): each sorted
    query's left insertion point among the unique keys, ``probe_steps``
    rounds from its bucket's bounds, then its run's count and start where
    the key is there and the query valid.  Returns (counts, loc), (Q,)
    int32, as ``direct_probe``.  The kernel reads the keys as ``ukk``'s
    interleaved pairs (``ukeys`` and ``ukeys2`` are the twin's) and a hit's
    start and count as one pair: ``ustart`` and ``ucount`` must be the two
    columns of one (U, 2) int32 tensor, as SearchAux holds them.  Raises
    for an empty table, for another layout, and where the launcher refuses
    (``probe_steps`` past its 32 rounds)."""
    kw = dict(upshift=upshift, bucket_bits=bucket_bits, probe_steps=probe_steps,
              use_k2=use_k2)
    if _query_tensors("binary_probe", keyf, key2f, validf, ukk, sbucket,
                      bucket_bits=bucket_bits, columns=(ukeys, ukeys2, ustart, ucount)):
        return binary_probe_torch(keyf, key2f, validf, ukeys, ukeys2, ukk, ustart, ucount,
                                  sbucket, **kw)
    nuniq = ukeys.shape[0]
    if nuniq == 0 or ukk.shape[0] != 2 * nuniq or not (
            ustart.shape[0] == ucount.shape[0] == nuniq):
        raise ValueError("binary_probe: needs a nonempty table with ukk of 2 x its keys "
                         "and a start and count a key")
    if not (ustart.dtype == ucount.dtype == torch.int32 and ustart.stride() == (2,)
            and ucount.stride() == (2,) and ucount.data_ptr() == ustart.data_ptr() + 4):
        raise ValueError("binary_probe: ustart and ucount must be the two columns of one "
                         "(U, 2) int32 tensor")
    if not keyf.shape[0]:
        return _outputs(keyf)
    out = _launch_binary(keyf, key2f, validf, ukk, ustart, nuniq, sbucket, **kw)
    binary_probe.launches += 1
    return out


direct_probe.launches = 0
binary_probe.launches = 0
