"""B5: window keys and validity of every (window, read) in one pass.

``window_queries`` launches the CUDA kernel in ``csrc/windows.cu`` (it
replaces ``muscato_tpu/ops/pallas_windows.py:window_queries_pallas``);
``window_queries_torch`` is its plain PyTorch twin (the port of
``muscato_tpu/ops/fused.py:_window_queries``), which the wrapper runs for
CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import _lib
from . import windows as winops
from .packed import M32, mulmod32, popcount32, to_i32, u64

MAX_WINDOWS = 64  # the kernel's per-launch window table


def window_queries_torch(rpacked, lengths, q1s, *, width, min_dinuc):
    """Plain twin of ``window_queries``."""
    nreads, nw = rpacked.shape
    use_k2 = winops.uses_second_key(width)
    mult = int(winops.key_multiplier(width))
    mult2 = int(winops.HASH_MULT2)

    nal = -(-width // 8)  # aligned words covering the window
    nsl = nal + 1  # sliced words (one extra feeds the funnel shift)
    padn = max(1, nsl - nw)
    rp = u64(torch.nn.functional.pad(rpacked, (0, padn)))
    nwp = nw + padn

    keys, keys2, valids = [], [], []
    for q1 in q1s:
        w0 = min(max(q1 >> 3, 0), nwp - nsl)
        sh = min(max((q1 - (w0 << 3)) * 4, 0), 31)
        words = rp[:, w0 : w0 + nsl]
        al = []
        for j in range(nal):
            lo = words[:, j] >> sh
            hi = (words[:, j + 1] << (32 - sh)) & M32 if sh else 0
            al.append(lo | hi)
        key = torch.zeros(nreads, dtype=torch.int64, device=rpacked.device)
        key2 = torch.zeros_like(key)
        bits = torch.zeros_like(key)
        prev = None
        for i in range(width):
            b = (al[i >> 3] >> ((i & 7) * 4)) & 0xF
            key = (mulmod32(key, mult) + b) & M32
            if use_k2:
                key2 = (mulmod32(key2, mult2) + b) & M32
            if min_dinuc > 0 and prev is not None:
                # A shift past bit 31 gives 0, as a uint32 shift does.
                pr = prev * winops.NBASE + b
                one = torch.bitwise_left_shift(torch.ones_like(pr), pr.clamp(max=31))
                bits = bits | torch.where(pr < 32, one, 0)
            prev = b
        v = lengths >= q1 + width
        if min_dinuc > 0:
            v = v & (popcount32(bits & M32) >= min_dinuc)
        keys.append(key)
        keys2.append(key2)
        valids.append(v)

    key = to_i32(torch.stack(keys).reshape(-1))
    key2 = to_i32(torch.stack(keys2).reshape(-1))
    valid = torch.stack(valids).reshape(-1)
    return key, key2, valid


def _window_table(nw: int, q1s, width: int) -> list[int]:
    """(w0, sh, q1 + width) per window, flattened: the clipped first word
    of each window's slice and its funnel shift, as the twin computes
    them, and the length gate."""
    nsl = -(-width // 8) + 1
    last = max(nw + 1 - nsl, 0)  # the twin's nwp - nsl
    out = []
    for q1 in q1s:
        w0 = min(max(q1 >> 3, 0), last)
        out += [w0, min(max((q1 - (w0 << 3)) * 4, 0), 31), q1 + width]
    return out


def window_queries(rpacked, lengths, q1s, *, width, min_dinuc):
    """Window keys + validity for every (window, read), flattened to (K*R,)
    window-major (``k*R + r``), from the nibble-packed read matrix
    ``rpacked`` (R, nw) int32 and ``lengths`` (R,) int32.

    Returns ``(key1, key2, valid)``: int32 bit patterns of the uint32 Horner
    keys (mod 2**32; key2 is 0 unless width > 13) and a bool mask, the
    length gate AND, when min_dinuc > 0, at least min_dinuc distinct
    dinucleotides.  Windows past the packed width read a clipped slice,
    exactly as ``muscato_tpu.ops.fused._window_queries`` does."""
    q1s = tuple(int(q) for q in q1s)
    if _lib.on_cpu("window_queries", rpacked, lengths):
        return window_queries_torch(
            rpacked, lengths, q1s, width=width, min_dinuc=min_dinuc
        )
    nreads, nw = rpacked.shape
    nwin = len(q1s)
    if not 1 <= nwin <= MAX_WINDOWS:
        raise ValueError(f"window_queries: takes 1..{MAX_WINDOWS} windows, got {nwin}")
    if width < 1 or nw < 1 or lengths.shape != (nreads,):
        raise ValueError("window_queries: bad width or shapes")
    dev = rpacked.device
    key1 = torch.empty(nwin * nreads, dtype=torch.int32, device=dev)
    key2 = torch.empty(nwin * nreads, dtype=torch.int32, device=dev)
    valid = torch.empty(nwin * nreads, dtype=torch.bool, device=dev)
    if nreads:
        table = _window_table(nw, q1s, width)
        params = (ctypes.c_longlong * len(table))(*table)
        _lib.launch(
            "window_queries", rpacked, rpacked.data_ptr(), lengths.data_ptr(),
            nreads, nw, ctypes.addressof(params), nwin, width, min_dinuc,
            int(winops.key_multiplier(width)), int(winops.HASH_MULT2),
            int(winops.uses_second_key(width)), key1.data_ptr(),
            key2.data_ptr(), valid.data_ptr(),
        )
        window_queries.launches += 1
    return key1, key2, valid


window_queries.launches = 0
