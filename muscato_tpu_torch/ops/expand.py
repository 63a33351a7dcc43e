"""B2: per-pair owner expansion of the compacted probe slots.

``expand_owners`` launches the CUDA kernel in ``csrc/expand.cu`` (it
replaces ``muscato_tpu/ops/pallas_expand.py:expand_owners``);
``expand_owners_torch`` is its plain PyTorch twin, which the wrapper runs
for CPU tensors.
"""

from __future__ import annotations

import torch

from . import _lib


def expand_owners_torch(oexcl, lo, qid, *, pair_cap: int):
    """Plain twin of ``expand_owners``."""
    m = oexcl.shape[0]
    pid = torch.arange(pair_cap, dtype=torch.int64, device=oexcl.device)
    owner = (torch.searchsorted(oexcl, pid, side="right") - 1).clamp(0, m - 1)
    sidx = lo[owner].to(torch.int64) + (pid - oexcl[owner].to(torch.int64))
    return qid[owner], sidx.to(torch.int32)


def expand_owners(oexcl, lo, qid, *, pair_cap: int):
    """Per-pair (qid, flat postings index) from compacted probe slots.

    ``oexcl`` is the nondecreasing exclusive prefix sum of the slot counts
    (slot s owns pair lanes [oexcl[s], oexcl[s+1])); ``lo``/``qid`` are the
    slot's postings start and flat query id.  Returns ``(qid_lane, sidx)``,
    each (pair_cap,) int32; lanes past the pair total carry the last slot's
    values, as in the Pallas kernel."""
    if oexcl.shape[0] == 0:
        raise ValueError("expand_owners: needs at least one slot")
    if _lib.on_cpu("expand_owners", oexcl, lo, qid):
        return expand_owners_torch(oexcl, lo, qid, pair_cap=pair_cap)
    m = oexcl.shape[0]
    qid_out = torch.empty(pair_cap, dtype=torch.int32, device=qid.device)
    sidx = torch.empty(pair_cap, dtype=torch.int32, device=qid.device)
    if pair_cap:
        _lib.launch(
            "expand_owners", qid, oexcl.data_ptr(), lo.data_ptr(),
            qid.data_ptr(), m, pair_cap, qid_out.data_ptr(), sidx.data_ptr(),
        )
        expand_owners.launches += 1
    return qid_out, sidx


expand_owners.launches = 0
