"""Seeded inputs of the element gather (``ops/gather.py`` monotone_gather,
B3), shared by the tests that hold the port's twin against the JAX package
on the CPU (test_torch_gather.py) and the tests that hold the CUDA kernel
against its twin on the card (test_torch_gather_cuda.py), and a model of
how the kernel splits the outputs among its threads.  It imports nothing
of JAX, so the card tests run where JAX is not installed.

Each case is a table, an index stream and two offsets in words, 0-3, from
16-byte alignment: where the indices start in their buffer and where the
kernel is to write the outputs in its buffer (the card test launches into
a slice of a larger buffer; the wrapper's own outputs start aligned)."""

import numpy as np

RUN = 4  # outputs a thread of the kernel takes at once (csrc/gather.cu kRun)
THREADS = 256  # threads a CTA (kGatherThreads)

# The index streams: nondecreasing; piecewise nondecreasing with
# step-backs (a postings run re-expanded for several queries, as the
# streaming chunks and the rank feed B3); scattered; one index repeated;
# and streams with indices below 0 and at or past the table's end, which
# the kernel clamps to the first and last entry.
KINDS = ("monotone", "step-backs", "scattered", "one-index", "clamped")
OFFSETS = ((0, 0), (1, 3), (2, 2), (3, 1), (0, 1), (2, 0))


def _case_list():
    cases = {}
    for i, kind in enumerate(KINDS):
        for idx_off, out_off in OFFSETS:
            cases[f"{kind}-m5003-idx{idx_off}-out{out_off}"] = (
                100 + i, 70_000, 5003, kind, idx_off, out_off)
    # m from 0 to 40: heads and tails alone, one run, a run and a tail.
    for m in range(41):
        cases[f"monotone-m{m}"] = (200 + m, 1000, m, "monotone", m % 4, (m // 4) % 4)
    # m near multiples of the run, at every pair of offsets.
    for m in (4095, 4096, 4097, 4098):
        for idx_off, out_off in ((0, 0), (1, 2), (3, 3)):
            cases[f"step-backs-m{m}-idx{idx_off}-out{out_off}"] = (
                300 + m, 20_000, m, "step-backs", idx_off, out_off)
    # A table of one entry.
    for kind in ("one-index", "clamped"):
        cases[f"{kind}-table1-m37"] = (400, 1, 37, kind, 1, 2)
    return cases


CASES = _case_list()


def gather_inputs(name):
    """One case: (table (n,) int32, buffer holding the indices at
    [idx_off, idx_off + m) int32, idx_off, out_off); the indices are
    buffer[idx_off:]."""
    seed, n, m, kind, idx_off, out_off = CASES[name]
    rng = np.random.default_rng(seed)
    table = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    if kind == "monotone":
        idx = np.sort(rng.integers(0, n, m))
    elif kind == "step-backs":
        parts, left = [], m
        while left:
            k = min(left, int(rng.integers(1, 300)))
            start = int(rng.integers(0, n))
            parts.append(np.minimum(start + np.cumsum(rng.integers(0, 3, k)), n - 1))
            left -= k
        idx = np.concatenate(parts) if parts else np.zeros(0, np.int64)
    elif kind == "scattered":
        idx = rng.integers(0, n, m)
    elif kind == "one-index":
        idx = np.full(m, int(rng.integers(0, n)))
    else:  # clamped: in-range runs with indices below 0 and past the end
        idx = np.sort(rng.integers(0, n, m))
        bad = rng.random(m) < 0.2
        idx[bad] = np.where(rng.random(bad.sum()) < 0.5,
                            -rng.integers(1, 2**31, bad.sum()),
                            n + rng.integers(0, 2**31 - n, bad.sum()))
    buf = rng.integers(-2**31, 2**31, idx_off + m + 3, dtype=np.int64).astype(np.int32)
    buf[idx_off: idx_off + m] = idx
    return table, buf, idx_off, out_off


def expected(table, idx):
    """table[clamp(idx, 0, n - 1)] in numpy."""
    return table[np.clip(idx.astype(np.int64), 0, len(table) - 1)]


def split_model(m, idx_off, out_off):
    """The kernel's split of m outputs, as csrc/gather.cu's launcher and
    gather_kernel compute it, with the indices and outputs ``idx_off`` and
    ``out_off`` words past a 16-byte boundary: the head up to out's first
    boundary, runs of RUN from there, a thread a run, the tail, and the
    head's and tail's outputs taken by the grid's last threads, in CTAs of
    THREADS.  Returns (writes, vector index loads, stores): how often each
    output is written, and the word offsets (from the 16-byte boundary)
    where the 16-byte index loads and stores fall."""
    if m <= 0:
        return np.zeros(max(m, 0), np.int64), [], []
    head = min((16 - 4 * out_off) // 4 % RUN, m)
    nrun = (m - head) // RUN
    nthreads = -(-(nrun + (m - nrun * RUN)) // THREADS) * THREADS
    idx_vec = idx_off % 4 == out_off % 4
    tail = head + nrun * RUN
    writes = np.zeros(m, np.int64)
    loads, stores = [], []
    for t in range(nthreads):
        e = nthreads - 1 - t  # the head's and tail's outputs from the grid's last thread on
        j1 = e if e < head else tail + (e - head)
        if j1 < m:
            writes[j1] += 1
        if t < nrun:
            j = head + t * RUN
            if idx_vec:
                loads.append(idx_off + j)
            stores.append(out_off + j)
            writes[j: j + RUN] += 1
    return writes, loads, stores
