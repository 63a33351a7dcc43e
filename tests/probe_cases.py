"""Inputs for the search probe's kernels, B8 (``ops/search.py``
direct_probe) and B9 (binary_probe), and their plain twins: sorted key
tables turned into a search aux by the port's build, and sorted query
batches that reach each branch of the kernels (empty buckets, buckets of
1 and of 16 records, the last bucket, queries past the last unique key,
invalid queries, widths with and without the second key word, the
padding records' keys, a binary table whose largest bucket needs every
search step, a bucket of exactly 16 records whose key1 repeats, a binary
bucket of 2**probe_steps - 1 keys).  Numpy and the port only, no JAX: the card's tests
(test_torch_probe_cuda.py) and chip_smoke.py use them too.  Also a
per-query model of each kernel: the one-thread kernels of the
-DMUSCATO_NO_STAGE build (``direct_model``, ``binary_model``) and those of
the default build (``direct_group_model``, ``binary_window_model``), which
the CPU tests hold against the twins."""

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

    # Width 12 at 16 bucket bits (upshift 4: a bucket is bits 27..12 of
    # key1): one bucket of exactly 16 records, key1 repeated under other
    # key2 words, so that a query's hits (which ignore key2) lie in several
    # lanes' records and its last record is the bucket's sixteenth.
    base = 0x0ABC << 12
    low = np.array([0, 0, 0, 1, 1] + list(range(2, 13)))
    k1 = np.concatenate([base + low, (rng.choice(np.arange(20, 0xE800), 1500, replace=False)
                                      << 12) + _u32(rng, 1500, 2**12)]).astype(np.uint32)
    k2 = _u32(rng, k1.size)
    k1, k2 = _sorted(k1, k2)
    q = _queries(rng, k1, k2, 4000, last_bucket=list(base + np.arange(-1, 14)))
    aux = aux_of(k1, k2, 12)
    sb = aux.sbucket.numpy()
    assert aux.mode == "direct" and aux.bucket_bits == 16 and sb[0x0ABC + 1] - sb[0x0ABC] == 16
    out["a bucket of exactly 16 records, w12"] = ("direct", aux, 12, q)

    # Width 20 at 16 bucket bits, binary: the largest bucket holds 63 =
    # 2**6 - 1 keys, the most that probe_steps 6 covers, key1 repeated
    # under other key2 words among them.
    base = 0x4321 << 16
    low = np.sort(np.concatenate([rng.choice(np.arange(1, 2**16 - 1), 53, replace=False),
                                  np.repeat(rng.choice(np.arange(1, 2**16 - 1), 5), 2)]))
    k1 = np.concatenate([base + low, (rng.choice(np.arange(0x4400, 0xFF00), 4000,
                                                 replace=False) << 16)]).astype(np.uint32)
    k2 = _u32(rng, k1.size)
    k1, k2 = _sorted(k1, k2)
    edges = [base, base + low[0], base + low[0] + 1, base + low[-1], base + low[-1] + 1,
             base + 2**16 - 1, base - 1]
    q = _queries(rng, k1, k2, 6000, last_bucket=edges + list(base + low[::7]))
    aux = aux_of(k1, k2, 20, 0)
    assert aux.mode == "binary" and aux.probe_steps == 6 and int(aux.sbucket.diff().max()) == 63
    out["a binary bucket of 2**probe_steps - 1 keys"] = ("binary", aux, 20, q)
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


def to_device(kind, args, dev) -> tuple:
    """probe_args' arguments on ``dev``, the binary aux's column views kept
    as views of one key-pair tensor and one (start, count) pair tensor (a
    view moved alone becomes a tensor of its own, which B9 refuses)."""
    if kind == "direct":
        return tuple(a.to(dev) for a in args)
    keyf, key2f, validf, ukeys, _, ukk, ustart, _, sbucket = args
    kk = ukk.to(dev).view(-1, 2)
    sc = ustart.as_strided((ukeys.numel(), 2), (2, 1)).to(dev)
    return (keyf.to(dev), key2f.to(dev), validf.to(dev), kk[:, 0], kk[:, 1], kk.view(-1),
            sc[:, 0], sc[:, 1], sbucket.to(dev))


def _np(t) -> np.ndarray:
    return t.numpy().view(np.uint32).astype(np.int64)


def _ignore(array, index, nbytes):
    pass


def direct_model(keyf, key2f, validf, urec, sbucket, *, upshift, bucket_bits, bucket_width,
                 use_k2, touch=_ignore):
    """csrc/probe.cu direct_probe_thread_kernel's loop, one query at a time;
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
    """csrc/probe.cu binary_probe_thread_kernel's loop, one query at a time: it
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


# The default build's designs (csrc/probe.cu): B8's lanes a query, B9's
# key pairs a round and its rounds that guess by interpolation.
DIRECT_GROUP = 4  # kDirectGroup
BINARY_WINDOW = 4  # kBinaryWindow
INTERPOLATED_ROUNDS = 2  # kInterpolatedRounds


def direct_group_model(keyf, key2f, validf, urec, sbucket, *, upshift, bucket_bits,
                       bucket_width, use_k2):
    """csrc/probe.cu direct_probe_kernel, one query at a time: lane l of
    DIRECT_GROUP loads the records l, l + DIRECT_GROUP, ... below the
    bucket's count (min(its size, bucket_width)), sums its hits' counts and
    starts as uint32, and the lanes' sums meet by a butterfly of xor
    shuffles."""
    group = DIRECT_GROUP
    k1s, k2s, rec, sb = _np(keyf), _np(key2f), _np(urec).reshape(-1, 4), _np(sbucket)
    counts, loc = np.zeros(k1s.size, np.int64), np.zeros(k1s.size, np.int64)
    for i, (k1, k2) in enumerate(zip(k1s, k2s)):
        b = ((k1 << upshift) & M32) >> (32 - bucket_bits)
        lo, nb = sb[b], min(sb[b + 1] - sb[b], bucket_width)
        c, s = [0] * group, [0] * group
        for lane in range(group):
            for j in range(lane, 16, group):
                r = rec[lo + j] if j < nb else None
                if r is not None and r[0] == k1 and (not use_k2 or r[1] == k2):
                    c[lane], s[lane] = (c[lane] + r[3]) & M32, (s[lane] + r[2]) & M32
        off = group // 2
        while off:
            c = [(c[lane] + c[lane ^ off]) & M32 for lane in range(group)]
            s = [(s[lane] + s[lane ^ off]) & M32 for lane in range(group)]
            off //= 2
        counts[i], loc[i] = (c[0] if validf[i] else 0), s[0]
    return counts, loc


def _guess(lo, m, q, vlo, vhi, rnd, hashed) -> int:
    """B9's window guess in [lo, lo + m): over ``hashed`` keys, the key1
    image q placed between the images vlo..vhi bounding the range, in
    float32 as the kernel computes it, for its interpolated rounds; else
    the middle."""
    if hashed and rnd < INTERPOLATED_ROUNDS and vlo <= q <= vhi:
        f32 = np.float32
        frac = f32(q - vlo) / (f32(vhi - vlo) + f32(1.0)) * f32(m)
        return lo + min(m - 1, int(frac))
    return lo + (m - 1) // 2


def binary_window_model(keyf, key2f, validf, ukeys, ukeys2, ukk, ustart, ucount, sbucket, *,
                        upshift, bucket_bits, probe_steps, use_k2):
    """csrc/probe.cu binary_probe_kernel, one query at a time: rounds of
    BINARY_WINDOW probes x(0) <= ... <= x(window - 1) inside [lo, hi),
    whose "below the query" bits must be a prefix of c (0 < c < window:
    the insertion point p is x(c - 1) + 1 = x(c); c = 0: p <= x(0); c =
    window: p > x(window - 1)), down to p: a window of pairs aligned to its
    size around a guess (_guess, by interpolation where use_k2, whose keys
    are hashes; the images bounding the range are the bucket's, then those
    of the probes that ended a round); then the
    twin's probe_steps rounds replayed on indices (mid < p); the hit from
    the probe that set hi, or, where none did, from the key at min(lo, n -
    1); an invalid query searches nothing."""
    window = BINARY_WINDOW
    k1s, k2s, kk, sb = _np(keyf), _np(key2f), _np(ukk).reshape(-1, 2), _np(sbucket)
    st, ct = ustart.numpy().astype(np.int64), ucount.numpy().astype(np.int64)
    n = kk.shape[0]
    counts, loc = np.zeros(k1s.size, np.int64), np.zeros(k1s.size, np.int64)
    tail = M32 >> bucket_bits
    for i, (k1, k2) in enumerate(zip(k1s, k2s)):
        if not validf[i]:
            continue
        key = (k1, k2 if use_k2 else 0)
        entry = lambda x: (kk[x][0], kk[x][1] if use_k2 else 0)  # noqa: E731
        image = lambda k: (k << upshift) & M32  # noqa: E731
        b = image(k1) >> (32 - bucket_bits)
        lo0, hi0 = sb[b], sb[b + 1]
        lo, hi, hi_probed, hi_equal = lo0, hi0, False, False
        q, vlo = image(k1), b << (32 - bucket_bits)
        vhi, rnd = vlo | tail, 0
        while lo < hi:
            m = hi - lo
            start = _guess(lo, m, q, vlo, vhi, rnd, use_k2) & ~(window - 1)
            xs = [min(max(start + j, lo), hi - 1) for j in range(window)]
            below = [entry(x) < key for x in xs]
            c = sum(below)
            assert below == [True] * c + [False] * (window - c)
            if c == window:
                lo, vlo = xs[-1] + 1, image(kk[xs[-1]][0])
            else:
                lo = lo if c == 0 else xs[c - 1] + 1
                hi, vhi = xs[c], image(kk[xs[c]][0])
                hi_probed, hi_equal = True, entry(xs[c]) == key
            rnd += 1
        tlo, thi = lo0, hi0
        for _ in range(probe_steps):
            if tlo >= thi:
                break
            mid = (tlo + thi) >> 1
            tlo, thi = (mid + 1, thi) if mid < lo else (tlo, mid)
        if tlo == lo and hi_probed:
            at, hit = lo, hi_equal
        else:
            at = min(tlo, n - 1)
            hit = tlo < n and entry(at) == key
        if hit:
            counts[i], loc[i] = ct[at], st[at]
    return counts, loc
