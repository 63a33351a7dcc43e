"""B2 and B6: per-pair owner expansion of the compacted probe slots.

``expand_owners`` launches one of the two CUDA kernels in
``csrc/expand.cu``: B2 (it replaces
``muscato_tpu/ops/pallas_expand.py:expand_owners``), or with
``subchunk=True`` B6, through ``expand_owners_sub`` (it replaces the same
function's sub-chunked kernel ``_kernel_sub``), which stages each CTA's slot
window in shared memory.  Both compute one function, and
``expand_owners_torch`` is the plain PyTorch twin of both, which the
wrappers run for CPU tensors.
"""

from __future__ import annotations

import torch

from . import _lib


def expand_owners_torch(oexcl, lo, qid, *, pair_cap: int):
    """Plain twin of ``expand_owners`` and ``expand_owners_sub``."""
    m = oexcl.shape[0]
    pid = torch.arange(pair_cap, dtype=torch.int64, device=oexcl.device)
    owner = (torch.searchsorted(oexcl, pid, side="right") - 1).clamp(0, m - 1)
    sidx = lo[owner].to(torch.int64) + (pid - oexcl[owner].to(torch.int64))
    return qid[owner], sidx.to(torch.int32)


def _expand(name, wrapper, oexcl, lo, qid, pair_cap):
    """The body of both wrappers: the twin for CPU tensors, else a launch
    of the kernel ``muscato_<name>``, counted on ``wrapper``."""
    if oexcl.shape[0] == 0:
        raise ValueError(f"{name}: needs at least one slot")
    if _lib.on_cpu(name, oexcl, lo, qid):
        return expand_owners_torch(oexcl, lo, qid, pair_cap=pair_cap)
    m = oexcl.shape[0]
    qid_out = torch.empty(pair_cap, dtype=torch.int32, device=qid.device)
    sidx = torch.empty(pair_cap, dtype=torch.int32, device=qid.device)
    if pair_cap:
        _lib.launch(
            name, qid, oexcl.data_ptr(), lo.data_ptr(), qid.data_ptr(), m,
            pair_cap, qid_out.data_ptr(), sidx.data_ptr(),
        )
        wrapper.launches += 1
    return qid_out, sidx


def expand_owners_sub(oexcl, lo, qid, *, pair_cap: int):
    """``expand_owners`` through the sub-chunked B6 kernel."""
    return _expand("expand_owners_sub", expand_owners_sub, oexcl, lo, qid, pair_cap)


def expand_owners(oexcl, lo, qid, *, pair_cap: int, subchunk: bool = False):
    """Per-pair (qid, flat postings index) from compacted probe slots.

    ``oexcl`` is the nondecreasing exclusive prefix sum of the slot counts
    (slot s owns pair lanes [oexcl[s], oexcl[s+1])); ``lo``/``qid`` are the
    slot's postings start and flat query id.  Returns ``(qid_lane, sidx)``,
    each (pair_cap,) int32; lanes past the pair total carry the last slot's
    values, as in the Pallas kernel.  ``subchunk`` selects B6, which
    computes the same function."""
    if subchunk:
        return expand_owners_sub(oexcl, lo, qid, pair_cap=pair_cap)
    return _expand("expand_owners", expand_owners, oexcl, lo, qid, pair_cap)


expand_owners.launches = 0
expand_owners_sub.launches = 0
