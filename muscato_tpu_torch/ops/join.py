"""B1: sorted join of sorted queries against the sorted window-key index.

``sorted_join`` launches the CUDA kernel in ``csrc/join.cu`` (it replaces
``muscato_tpu/ops/pallas_join.py:sorted_join``); ``sorted_join_torch`` is
its plain PyTorch twin, which the wrapper runs for CPU tensors.
"""

from __future__ import annotations

import torch

from . import _lib

_SIGN = -(1 << 31)


def flip(u: torch.Tensor) -> torch.Tensor:
    """uint32 bit patterns held as int32 -> int32 whose signed order is the
    unsigned order of the patterns (``pallas_join._flip``)."""
    return u ^ _SIGN


def sorted_join_torch(skeys: torch.Tensor, qkeys: torch.Tensor):
    """Plain twin of ``sorted_join``."""
    s = flip(skeys)
    q = flip(qkeys)
    lo = torch.searchsorted(s, q, side="left")
    hi = torch.searchsorted(s, q, side="right")
    return lo.to(torch.int32), (hi - lo).to(torch.int32), 0


def sorted_join(skeys: torch.Tensor, qkeys: torch.Tensor):
    """lo[i] = #{skeys < qkeys[i]}, count[i] = #{skeys == qkeys[i]}, both
    compared as uint32, for a sorted ``skeys`` (int32 bit patterns of uint32
    keys).  Returns ``(lo, count, overflow)`` like the Pallas kernel; a
    query tile whose index span is wider than the kernel stages searches
    global memory, so overflow is always 0."""
    if _lib.on_cpu("sorted_join", skeys, qkeys):
        return sorted_join_torch(skeys, qkeys)
    v, m = skeys.shape[0], qkeys.shape[0]
    lo = torch.empty(m, dtype=torch.int32, device=qkeys.device)
    cnt = torch.empty(m, dtype=torch.int32, device=qkeys.device)
    if m:
        _lib.launch(
            "sorted_join", qkeys, skeys.data_ptr(), v, qkeys.data_ptr(), m,
            lo.data_ptr(), cnt.data_ptr(),
        )
        sorted_join.launches += 1
    return lo, cnt, 0


sorted_join.launches = 0
