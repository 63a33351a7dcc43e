"""Full-read pair verification, byte path, and the mismatch budget (port
of ``muscato_tpu/ops/verify.py``).

``verify_pairs_dynq`` is the readable specification of the verify: a dense
(pairs x MaxReadLength) mismatch count over the byte codes.  The engine
runs the SWAR verifies of ``ops/packed.py`` instead; this plain function
is their reference (the tests fuzz both against it), and a fused verify
kernel's twin.

Semantics (file:line cites into the reference):

  - a pair survives only if the read's window region equals the target
    window (the reference joins on the k-mer string; here it also
    rejects hash collisions for wide windows);
  - the site must leave room for the read's left tail: p_local >= q1
    (screen main.go:340-346);
  - the gene must not end before the read: the stored right tail is
    capped at MaxReadLength - q2 past the window (screen main.go:348-351)
    and, the reference's hard-coded quirk, at absolute position 100 - q2
    for window-offset-0 hits at target position 0 (screen main.go:305);
  - the mismatch budget is int((1 - PMatch) * readlen), computed in
    float64 with truncation toward zero (confirm main.go:198), passed in
    as a per-length lookup table;
  - nmiss counts mismatches over the whole read (confirm main.go:206-208).
"""

from __future__ import annotations

import numpy as np
import torch

from .packed import gene_of_pos


def verify_pairs_dynq(
    r: torch.Tensor,  # (P,) int32 read rows (-1 = inactive lane)
    p: torch.Tensor,  # (P,) int32 global window positions (-1 = inactive)
    codes: torch.Tensor,  # (R, Lmax) uint8
    lengths: torch.Tensor,  # (R,) int32
    tcat: torch.Tensor,  # (S,) uint8
    gene_start: torch.Tensor,  # (G+1,) int32
    budget: torch.Tensor,  # (Lmax+1,) int32 mismatch budget per read length
    q1,  # int or 0-d int tensor: the window offset
    width: int,
    max_read_length: int,
):
    """Verify each (read, site) pair; returns (keep, nx, g, s): keep (P,)
    bool, nx the full-read mismatch count, g the gene (a binary search
    over gene_start), s the read start within the gene (the reported
    position), each (P,) int32."""
    q1 = torch.as_tensor(q1, dtype=torch.int32, device=r.device)
    q2 = q1 + width
    smax = tcat.shape[0]
    active = (r >= 0) & (p >= 0)
    rc = r.clamp(0, codes.shape[0] - 1).long()
    pc = p.clamp(0, smax - 1)

    g = gene_of_pos(gene_start, pc)
    gstart = gene_start[g.long()]
    glen = gene_start[(g + 1).long()] - gstart
    p_local = pc - gstart
    rlen = lengths[rc]

    # Read start within the gene.
    s_local = p_local - q1
    left_ok = s_local >= 0

    # Right-tail length the reference would have stored for this site
    # (screen main.go:305 and :348-351), in gene-local coordinates.
    cap_norm = p_local + width + (max_read_length - q2)
    is_pos0 = (p_local == 0) & (q1 == 0)
    cap_abs = torch.where(is_pos0, 100 - q2, cap_norm)  # hard-coded reference quirk
    mrgt_len = torch.minimum(glen, cap_abs) - (p_local + width)
    fit_ok = (rlen - q2) <= mrgt_len

    # Mismatch counts over the aligned full read.
    cols = torch.arange(codes.shape[1], dtype=torch.int32, device=r.device)
    tpos = (pc - q1)[:, None] + cols[None, :]
    tchars = tcat[tpos.clamp(0, smax - 1).long()]
    neq = (tchars != codes[rc]) & (cols[None, :] < rlen[:, None])
    in_window = (cols >= q1) & (cols < q2)
    win_mm = (neq & in_window[None, :]).sum(dim=1)
    nx = neq.sum(dim=1).to(torch.int32)

    keep = (
        active & left_ok & fit_ok & (win_mm == 0)
        & (nx <= budget[rlen.clamp(0, budget.shape[0] - 1).long()])
    )
    return keep, nx, g.to(torch.int32), s_local.to(torch.int32)


def mismatch_budget_table(pmatch: float, max_read_length: int) -> np.ndarray:
    """budget[L] = int((1 - pmatch) * L), float64, truncated toward zero —
    bit-identical to Go's int((1-PMatch)*float64(len)) (confirm main.go:198)."""
    ls = np.arange(max_read_length + 1, dtype=np.float64)
    return np.trunc((np.float64(1.0) - np.float64(pmatch)) * ls).astype(np.int32)
