"""Inputs for the search probe's kernels, B8 (``ops/search.py``
direct_probe) and B9 (binary_probe), and their plain twins: sorted key
tables turned into a search aux by the port's build, and sorted query
batches that reach each branch of the kernels (empty buckets, buckets of
1 and of 16 records, the last bucket, queries past the last unique key,
invalid queries, widths with and without the second key word, the
padding records' keys, a binary table whose largest bucket needs every
search step).  Numpy and the port only, no JAX: the card's tests
(test_torch_probe_cuda.py) and chip_smoke.py use them too.  Also a
per-query model of each kernel's loop (``direct_model``,
``binary_model``), which the CPU tests hold against the twins."""

import functools

import numpy as np
import torch

from muscato_tpu_torch.engine import index as tindex
from muscato_tpu_torch.ops import windows as winops

M32 = 0xFFFFFFFF


def _u32(rng, n, hi=2**32):
    return rng.integers(0, hi, n, dtype=np.uint64).astype(np.uint32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


def _sorted(k1, k2):
    order = np.lexsort((k2, k1))
    return k1[order], k2[order]


def aux_of(k1, k2, width, max_direct_bits=None):
    """The port's search aux of the sorted (k1, k2) table on the CPU;
    ``max_direct_bits`` lowers MAX_DIRECT_BITS while it is built (0: the
    binary layout)."""
    saved = tindex.MAX_DIRECT_BITS
    if max_direct_bits is not None:
        tindex.MAX_DIRECT_BITS = max_direct_bits
    try:
        return tindex.build_search_aux_device(_t(k1), _t(k2), width)
    finally:
        tindex.MAX_DIRECT_BITS = saved


def _queries(rng, k1, k2, n, *, last_bucket=(), sort=True):
    """n queries against the sorted table (k1, k2): hits, key1 hits with
    another key2, misses, ``last_bucket`` keys, keys past the table's last
    key and the padding records' (0xFFFFFFFF, 0xFFFFFFFF); a fifth
    invalid.  Sorted by (key1, key2) as uint32 unless ``sort`` is false."""
    pick = rng.integers(0, k1.size, n // 2)
    q1 = [k1[pick], k1[pick[: n // 8]], _u32(rng, n // 4)]
    q2 = [k2[pick], _u32(rng, n // 8), _u32(rng, n // 4)]
    top = int(k1.max()) if k1.size else 0
    past = np.arange(top + 1, min(top + 9, 2**32), dtype=np.uint64).astype(np.uint32)
    extra1 = np.concatenate([np.asarray(last_bucket, np.uint32), past, [M32, M32, 0]])
    extra2 = np.concatenate([_u32(rng, len(last_bucket)), _u32(rng, past.size),
                             [M32, 0, 0]]).astype(np.uint32)
    q1 = np.concatenate(q1 + [extra1]).astype(np.uint32)
    q2 = np.concatenate(q2 + [extra2]).astype(np.uint32)
    valid = rng.random(q1.size) >= 0.2
    if sort:
        order = np.lexsort((q2, q1))
        q1, q2, valid = q1[order], q2[order], valid[order]
    return _t(q1), _t(q2), torch.from_numpy(valid)


@functools.lru_cache(maxsize=None)
def cases(seed: int = 0, scale: int = 1) -> dict:
    """{label: (kind, aux, width, (keyf, key2f, validf))}: kind 'direct'
    or 'binary'; ``scale`` multiplies the table and query sizes."""
    rng = np.random.default_rng(seed)
    out = {}
    # Width 20 (two key words): hash-uniform keys with duplicate runs,
    # equal key1 under other key2, key1 0 and 0xFFFFFFFF.
    n = 60_000 * scale
    k1 = np.concatenate([_u32(rng, n), np.repeat(_u32(rng, 500), 3),
                         [0, 0, M32, M32, M32]]).astype(np.uint32)
    k2 = _u32(rng, k1.size)
    k2[-3:] = (0, 7, M32)
    k2[n:n + 300] = 5  # equal (k1, k2) runs
    k1, k2 = _sorted(k1, k2)
    q = _queries(rng, k1, k2, 20_000 * scale, last_bucket=[M32 - 1, M32 - 2**10])
    out["w20 direct"] = ("direct", aux_of(k1, k2, 20), 20, q)
    out["w20 binary"] = ("binary", aux_of(k1, k2, 20, 0), 20, q)
    out["w20 direct, unsorted queries"] = (
        "direct", out["w20 direct"][1], 20,
        _queries(rng, k1, k2, 4096 * scale, sort=False))

    # Width 12 (key1 alone, keys below 5**12): queries carry key2 words
    # the kernel must ignore.
    hi = winops.NBASE ** 12
    k1 = np.sort(np.concatenate([_u32(rng, 30_000 * scale, hi), [0, hi - 1]])).astype(np.uint32)
    k2 = np.zeros_like(k1)
    q = _queries(rng, k1, k2, 12_000 * scale, last_bucket=[hi - 2, hi - 1])
    out["w12 direct"] = ("direct", aux_of(k1, k2, 12), 12, q)
    out["w12 binary"] = ("binary", aux_of(k1, k2, 12, 0), 12, q)

    # Width 20 at 16 bucket bits (upshift 0: a bucket is key1 >> 16):
    # buckets of 16 records, of 1, empty ones, and the last bucket full.
    fill = [(5 << 16) + 7 * np.arange(16), [9 << 16], (0xFFFF << 16) + np.arange(16) * 4093,
            np.arange(16) * 4096]
    sparse = (rng.choice(np.arange(10, 0xFFF0), 2000, replace=False) << 16) + _u32(rng, 2000, 2**16)
    k1 = np.concatenate(fill + [sparse]).astype(np.uint32)
    k2 = _u32(rng, k1.size)
    k1, k2 = _sorted(k1, k2)
    q = _queries(rng, k1, k2, 6000, last_bucket=[(0xFFFF << 16) + 1, M32])
    aux = aux_of(k1, k2, 20)
    assert aux.mode == "direct" and aux.bucket_bits == 16
    out["buckets of 0, 1 and 16 records"] = ("direct", aux, 20, q)

    # Width 13 (key1 alone; upshift 1, so a bucket at 16 bits is
    # key1 >> 15): a run of 3,000 consecutive keys fills one bucket, so
    # no direct table fits and the search needs every one of its steps.
    base = 37 << 15
    k1 = np.concatenate([base + np.arange(3000), (rng.choice(np.arange(40, 30_000), 500,
                         replace=False) << 15) + 11, [0, winops.NBASE ** 13 - 1]])
    k1 = np.sort(k1).astype(np.uint32)
    k2 = np.zeros_like(k1)
    q = _queries(rng, k1, k2, 8000, last_bucket=[base, base + 2999, base + 3000, base - 1])
    aux = aux_of(k1, k2, 13)
    assert aux.mode == "binary" and aux.probe_steps == 12
    out["binary, full steps"] = ("binary", aux, 13, q)
    return out


def probe_args(kind, aux, width, q) -> tuple:
    """(args, kw) of direct_probe / binary_probe for one case."""
    use_k2 = winops.uses_second_key(width)
    if kind == "direct":
        return (*q, aux.urec, aux.sbucket), dict(
            upshift=aux.upshift, bucket_bits=aux.bucket_bits,
            bucket_width=tindex.DIRECT_BUCKET_WIDTH, use_k2=use_k2)
    return (*q, aux.ukeys, aux.ukeys2, aux.ukk, aux.ustart, aux.ucount, aux.sbucket), dict(
        upshift=aux.upshift, bucket_bits=aux.bucket_bits, probe_steps=aux.probe_steps,
        use_k2=use_k2)


def _np(t) -> np.ndarray:
    return t.numpy().view(np.uint32).astype(np.int64)


def _ignore(array, index, nbytes):
    pass


def direct_model(keyf, key2f, validf, urec, sbucket, *, upshift, bucket_bits, bucket_width,
                 use_k2, touch=_ignore):
    """csrc/probe.cu direct_probe_kernel's loop, one query at a time;
    ``touch(array, index, nbytes)`` hears of each table entry it reads."""
    k1s, k2s, rec, sb = _np(keyf), _np(key2f), _np(urec).reshape(-1, 4), _np(sbucket)
    counts, loc = np.zeros(k1s.size, np.int64), np.zeros(k1s.size, np.int64)
    for i, (k1, k2) in enumerate(zip(k1s, k2s)):
        b = ((k1 << upshift) & M32) >> (32 - bucket_bits)
        lo = sb[b]
        touch("sbucket", b, 4)
        touch("sbucket", b + 1, 4)
        c = s = 0
        for j in range(min(sb[b + 1] - lo, bucket_width)):
            r = rec[lo + j]
            touch("urec", lo + j, 16)
            if r[0] == k1 and (not use_k2 or r[1] == k2):
                c, s = (c + r[3]) & M32, (s + r[2]) & M32
        counts[i], loc[i] = (c if validf[i] else 0), s
    return counts, loc


def binary_model(keyf, key2f, validf, ukeys, ukeys2, ukk, ustart, ucount, sbucket, *,
                 upshift, bucket_bits, probe_steps, use_k2, touch=_ignore):
    """csrc/probe.cu binary_probe_kernel's loop, one query at a time: it
    reads the keys as ``ukk``'s pairs and stops once lo == hi;
    ``touch(array, index, nbytes)`` hears of each table entry it reads."""
    k1s, k2s, kk, sb = _np(keyf), _np(key2f), _np(ukk).reshape(-1, 2), _np(sbucket)
    st, ct = ustart.numpy().astype(np.int64), ucount.numpy().astype(np.int64)
    n = kk.shape[0]
    counts, loc = np.zeros(k1s.size, np.int64), np.zeros(k1s.size, np.int64)
    for i, (k1, k2) in enumerate(zip(k1s, k2s)):
        b = ((k1 << upshift) & M32) >> (32 - bucket_bits)
        lo, hi = sb[b], sb[b + 1]
        touch("sbucket", b, 4)
        touch("sbucket", b + 1, 4)
        step = 0
        while step < probe_steps and lo < hi:
            mid = (lo + hi) >> 1
            m1, m2 = kk[mid]
            touch("ukk", mid, 8)
            if m1 < k1 or (use_k2 and m1 == k1 and m2 < k2):
                lo = mid + 1
            else:
                hi = mid
            step += 1
        at = min(lo, n - 1)
        touch("ukk", at, 8)
        hit = validf[i] and lo < n and kk[at][0] == k1 and (not use_k2 or kk[at][1] == k2)
        if hit:
            touch("ucount", at, 4)
            touch("ustart", at, 4)
        counts[i], loc[i] = (ct[at], st[at]) if hit else (0, 0)
    return counts, loc
