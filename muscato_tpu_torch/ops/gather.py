"""B3 and B4: the engine's monotone gathers.

``monotone_gather`` and ``monotone_gather_rows`` launch the CUDA kernels in
``csrc/gather.cu`` (they replace ``muscato_tpu/ops/pallas_gather.py``'s
functions of the same names); the ``*_torch`` functions are their plain
PyTorch twins, which the wrappers run for CPU tensors.  The engine feeds
both with (piecewise) nondecreasing index streams, which makes B3's loads
coalesce and keeps B4's tiles within the table span it stages in shared
memory; the values do not depend on it.
"""

from __future__ import annotations

import torch

from . import _lib


def monotone_gather_torch(table, idx):
    """Plain twin of ``monotone_gather``."""
    return table[idx.long()], 0


def monotone_gather_rows_torch(table, ridx):
    """Plain twin of ``monotone_gather_rows``."""
    return table[ridx.long()], 0


def monotone_gather(table, idx):
    """out[j] = table[idx[j]] for an int32 ``table`` and int32 ``idx`` in
    [0, len(table)).  Returns ``(out, overflow)`` like the Pallas kernel; the GPU
    kernel has no window, so overflow is always 0.  On the card a thread
    takes four consecutive outputs at once (``csrc/gather.cu``); ``idx``
    may start at any 4-byte offset."""
    if _lib.on_cpu("monotone_gather", table, idx):
        return monotone_gather_torch(table, idx)
    n, m = table.shape[0], idx.shape[0]
    if n == 0 and m:
        raise ValueError("monotone_gather: empty table")
    out = torch.empty(m, dtype=torch.int32, device=idx.device)
    if m:
        _lib.launch(
            "monotone_gather", idx, table.data_ptr(), n, idx.data_ptr(), m,
            out.data_ptr(),
        )
        monotone_gather.launches += 1
    return out, 0


def monotone_gather_rows(table, ridx):
    """out[j, :] = table[ridx[j], :] for an (R, NC) int32 ``table`` and
    int32 ``ridx`` in [0, R).  Returns ``(out (M, NC), overflow=0)``: a
    tile whose rows span more than the kernel stages reads them from
    global memory, so nothing overflows."""
    if _lib.on_cpu("monotone_gather_rows", table, ridx):
        return monotone_gather_rows_torch(table, ridx)
    nrows, ncols = table.shape
    m = ridx.shape[0]
    if nrows == 0 and m:
        raise ValueError("monotone_gather_rows: empty table")
    out = torch.empty((m, ncols), dtype=torch.int32, device=ridx.device)
    if m and ncols:
        _lib.launch(
            "monotone_gather_rows", ridx, table.data_ptr(), nrows, ncols,
            ridx.data_ptr(), m, out.data_ptr(),
        )
        monotone_gather_rows.launches += 1
    return out, 0


monotone_gather.launches = 0
monotone_gather_rows.launches = 0
