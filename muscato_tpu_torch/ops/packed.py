"""Nibble-packed sequences and the SWAR diagonal verify (port of
``muscato_tpu/ops/packed.py``).

Sequences are packed 8 bases per 32-bit word, one 4-bit nibble per base in
little-endian nibble order.  Packed words are stored as int32 bit patterns
(the JAX package's uint32 bytes); arithmetic that needs them unsigned runs
on int64 copies holding values in [0, 2**32), because torch has no logical
right shift on int32 and no uint32 shifts on the CPU.

Two verifies are ported, each with a CUDA kernel in ``csrc/verify.cu``:
``verify_diagonals_packed``, the dedup path's, in diagonal-major order
with the target-row view (``trows``) fetched by the B4 row gather and the
gene lookup on the B3 gather, and its SWAR body in B7
(``verify_diagonals_swar``, whose plain twin is
``verify_diagonals_swar_torch``); and ``verify_pairs_packed``, the
streaming path's, one pair a lane in the probe's lo order, whose row and
gene streams are not monotone: B10 does the whole verify, its fetches
included, one thread a lane (its plain twin, ``verify_pairs_packed_torch``,
fetches by plain indexing).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _lib
from .gather import monotone_gather, monotone_gather_rows

BASES_PER_WORD = 8
M32 = 0xFFFFFFFF
_NIB1 = 0x11111111


def u64(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2**32)."""
    return x.to(torch.int64) & M32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> their int32 bit patterns."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Population count of int64 values in [0, 2**32) (SWAR; torch has no
    popcount op)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24


def mulmod32(x: torch.Tensor, mult: int) -> torch.Tensor:
    """(x * mult) mod 2**32 for int64 x in [0, 2**32) and a 32-bit mult,
    with every partial product below 2**63 (no reliance on int64 wrap)."""
    mult = int(mult)
    lo = x * (mult & 0xFFFF)
    hi = ((x * (mult >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def packed_width(l: int) -> int:
    return -(-l // BASES_PER_WORD)


def pack_rows(codes: torch.Tensor) -> torch.Tensor:
    """(R, L) uint8 codes (values < 16) -> (R, ceil(L/8)) int32 holding the
    bit patterns of ``muscato_tpu.ops.packed.pack_rows_np``'s uint32 words,
    computed on the codes' device: two nibbles per byte, then four
    little-endian bytes per word."""
    nrows, l = codes.shape
    nw = packed_width(l)
    c = torch.nn.functional.pad(codes, (0, nw * BASES_PER_WORD - l))
    c = c.reshape(nrows, nw * 4, 2)
    return (c[..., 0] | (c[..., 1] << 4)).contiguous().view(torch.int32)


def unpack_rows(rpacked: torch.Tensor, l: int) -> torch.Tensor:
    """(R, NW) int32 nibble-packed -> (R, l) uint8 codes."""
    shifts = torch.arange(BASES_PER_WORD, dtype=torch.int64, device=rpacked.device) * 4
    nib = (u64(rpacked)[:, :, None] >> shifts[None, None, :]) & 0xF
    return nib.reshape(rpacked.shape[0], -1)[:, :l].to(torch.uint8)


# Tail padding on the packed target stream: enough words that a full
# max-length read slice starting at the last base stays in bounds
# (supports MaxReadLength up to 4096).
STREAM_PAD_WORDS = packed_width(4096) + 2


def pack_stream(tcat: np.ndarray) -> np.ndarray:
    """(S,) uint8 codes -> (ceil(S/8)+PAD,) uint32 with zero tail padding."""
    s = len(tcat)
    nw = packed_width(max(s, 1))
    arr = np.zeros((nw + STREAM_PAD_WORDS) * BASES_PER_WORD, dtype=np.uint32)
    arr[:s] = tcat
    arr = arr.reshape(-1, BASES_PER_WORD)
    shifts = (np.arange(BASES_PER_WORD, dtype=np.uint32) * 4).astype(np.uint32)
    return np.sum(arr << shifts[None, :], axis=1, dtype=np.uint32)


def pack_stream_device(tcat: torch.Tensor, chunk: int) -> torch.Tensor:
    """``pack_stream`` of the (S,) uint8 codes ``tcat`` (values < 16) as
    int32 bit patterns, computed on tcat's device ``chunk`` bases (rounded
    down to whole words) at a time."""
    s = tcat.shape[0]
    out = torch.zeros(packed_width(max(s, 1)) + STREAM_PAD_WORDS, dtype=torch.int32,
                      device=tcat.device)
    step = max(BASES_PER_WORD, chunk // BASES_PER_WORD * BASES_PER_WORD)
    for c0 in range(0, s, step):
        words = pack_rows(tcat[c0 : c0 + step][None])[0]
        w0 = c0 // BASES_PER_WORD
        out[w0 : w0 + words.shape[0]] = words
    return out


# ---- Row-gather target view -------------------------------------------
#
# trows[i] = tpacked[8*i : 8*i + nwords + 9]: one row per 64 stream
# positions, so a diagonal's nwords + 1 target words are one row fetch plus
# an in-row word offset in [0, 8).

TROWS_GUARD = 9
GENE_BLOCK_BITS = 8  # gene block table: one entry per 256 stream positions


def trows_nrows(smax: int) -> int:
    return max(1, (max(smax, 1) - 1) // 64 + 1)


def build_trows(tpacked: torch.Tensor, nwords: int, smax: int) -> torch.Tensor:
    """Overlapping (nrows, nwords + 9) int32 view of the packed stream,
    one row per 64 stream positions (a contiguous copy)."""
    rowlen = nwords + TROWS_GUARD
    nrows = trows_nrows(smax)
    need = 8 * (nrows - 1) + rowlen
    tp = tpacked
    if tp.shape[0] < need:
        tp = torch.nn.functional.pad(tp, (0, need - tp.shape[0]))
    return tp[:need].unfold(0, rowlen, 8).contiguous()


def _trows_select(t: torch.Tensor, woff: torch.Tensor, nwords: int) -> torch.Tensor:
    """3-level column select: rows fetched from trows -> the nwords+1
    stream words starting at each lane's in-row word offset (in [0, 8))."""
    for step in (4, 2, 1):
        pick = ((woff & step) != 0)[:, None]
        t = torch.where(pick, t[:, step:], t[:, : t.shape[1] - step])
    return t[:, : nwords + 1]


def _trows_fetch(trows: torch.Tensor, dc: torch.Tensor, nwords: int) -> torch.Tensor:
    """Words tpacked[dc>>3 : (dc>>3) + nwords + 1] of each lane: one row
    gather by plain indexing, then the 3-level column select."""
    base = dc >> 3
    t = trows[(base >> 3).clamp(0, trows.shape[0] - 1).long()]
    return _trows_select(t, base & 7, nwords)


def build_gene_block(gene_start_np: np.ndarray, smax: int):
    """Host-built block table for the gene lookup: gblock[b] = owning gene
    of stream position b*256, plus the refine step count (log2 of the
    widest block's gene span)."""
    gs = np.asarray(gene_start_np, dtype=np.int64)
    nb = (max(smax, 1) >> GENE_BLOCK_BITS) + 2
    marks = np.arange(nb, dtype=np.int64) << GENE_BLOCK_BITS
    gb = (np.searchsorted(gs[: len(gs)], marks, side="right") - 1).astype(np.int32)
    gb = np.clip(gb, 0, max(len(gs) - 2, 0))
    span = int((gb[1:] - gb[:-1]).max(initial=0))
    steps = max(span, 1).bit_length()
    return gb, steps


def gene_of_pos_block(gene_start, gblock, p, steps: int):
    """Owning gene of each position of a position stream p in any order:
    bounds from two adjacent gblock entries, then ``steps`` branchless
    refines, each fetch a plain gather."""
    g = gene_start.shape[0] - 1
    nb = gblock.shape[0]
    b = p >> GENE_BLOCK_BITS
    lo = gblock[b.clamp(0, nb - 1).long()]
    hi = gblock[(b + 1).clamp(0, nb - 1).long()]
    for _ in range(steps):
        mid = (lo + hi + 1) >> 1
        up = gene_start[mid.clamp(0, g).long()] <= p
        lo = torch.where(up, mid, lo)
        hi = torch.where(up, hi, mid - 1)
    return lo


def gene_of_pos_block_mono(gene_start, gblock, p, steps: int):
    """Owning gene of each position of a NONDECREASING position stream p:
    bounds from two gblock entries, then `steps` branchless refines.  Every
    fetch (bounds, each refine's gene_start probe, the final gene's start
    and end) is itself a monotone stream and rides the B3 gather.
    Returns (g, gstart, gend)."""
    g = gene_start.shape[0] - 1
    b = (p >> GENE_BLOCK_BITS).to(torch.int32)
    bc = b.clamp(0, gblock.shape[0] - 2)
    lo, _ = monotone_gather(gblock, bc)
    hi, _ = monotone_gather(gblock, bc + 1)
    for _ in range(steps):
        mid = (lo + hi + 1) >> 1
        gs_mid, _ = monotone_gather(gene_start, mid.clamp(0, g))
        up = gs_mid <= p
        lo = torch.where(up, mid, lo)
        hi = torch.where(up, hi, mid - 1)
    gstart, _ = monotone_gather(gene_start, lo.clamp(0, g))
    gend, _ = monotone_gather(gene_start, (lo + 1).clamp(0, g))
    return lo, gstart, gend


def gene_of_pos(gene_start: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Owning gene of each stream position: the largest g with
    gene_start[g] <= p, as an unrolled branchless binary search over the
    (G+1,) offsets table (the plain lookup; the engine's verifies use the
    block table of ``gene_of_pos_block``)."""
    g = gene_start.shape[0] - 1  # number of genes
    lo = torch.zeros(p.shape, dtype=torch.int32, device=p.device)
    hi = torch.full(p.shape, max(g - 1, 0), dtype=torch.int32, device=p.device)
    for _ in range(max(1, max(g - 1, 1).bit_length())):
        mid = (lo + hi + 1) >> 1
        go_up = gene_start[mid.long()] <= p
        lo = torch.where(go_up, mid, lo)
        hi = torch.where(go_up, hi, mid - 1)
    return lo


def _nibble_mask(k: torch.Tensor) -> torch.Tensor:
    """int64 mask with the low `k` nibbles set (k clipped to [0, 8])."""
    k = k.clamp(0, BASES_PER_WORD).to(torch.int64)
    return torch.bitwise_left_shift(torch.ones_like(k), 4 * k) - 1


def diagonal_fetch(r, d, gene_start, gblock, gsteps: int, trows, smax: int):
    """The dedup verify's fetches for (d, r)-sorted lanes: the owning gene
    of each diagonal on the B3 gather (``gene_of_pos_block_mono``) and its
    target row on the B4 row gather.  Returns (g, gstart, gend, t_rows)."""
    active = (r >= 0) & (d >= 0)
    dc = d.clamp(0, smax - 1)

    # Dead tail lanes (r < 0, sorted last) clamp to the last live position
    # so the position stream stays monotone through the tail.
    last_live = torch.where(active, dc, 0).max()
    dcm = torch.where(r >= 0, dc, last_live)
    g, gstart, gend = gene_of_pos_block_mono(gene_start, gblock, dcm, gsteps)
    # Inactive lanes map to the last row; negative diagonals already clamp
    # to row 0 through dc — both keep the row stream nondecreasing.
    row = torch.where(
        r >= 0, (dc >> 6).clamp(0, trows.shape[0] - 1), trows.shape[0] - 1
    ).to(torch.int32)
    t_rows, _ = monotone_gather_rows(trows, row)
    return g, gstart, gend, t_rows


def verify_diagonals_swar_torch(r, d, t_rows, rpacked, lengths, gstart, gend, budget,
                                q1s, *, width: int, smax: int):
    """Plain twin of ``verify_diagonals_swar``."""
    nwords = rpacked.shape[1]
    active = (r >= 0) & (d >= 0)
    rc = r.clamp(0, rpacked.shape[0] - 1)
    dc = d.clamp(0, smax - 1)
    glen = gend - gstart
    s_local = dc - gstart
    rlen = lengths[rc.long()]
    rshift = ((dc & 7) * 4).to(torch.int64)[:, None]
    tw = u64(_trows_select(t_rows, (dc >> 3) & 7, nwords))
    lowpart = tw[:, :-1] >> rshift
    hipart = torch.where(
        rshift == 0, 0, (tw[:, 1:] << ((32 - rshift) & 31)) & M32
    )
    taligned = lowpart | hipart

    x = taligned ^ u64(rpacked[rc.long()])
    wordbase = torch.arange(nwords, dtype=torch.int64, device=r.device) * BASES_PER_WORD
    x = x & _nibble_mask(rlen[:, None].to(torch.int64) - wordbase[None, :])
    nz = (x | (x >> 1) | (x >> 2) | (x >> 3)) & _NIB1
    nx = popcount32(nz).sum(dim=1).to(torch.int32)

    budget_ok = nx <= budget[rlen.clamp(0, budget.shape[0] - 1).long()]
    fit_norm = (rlen + s_local) <= glen
    fit_pos0 = rlen <= torch.minimum(glen, torch.full_like(glen, 100 - width))

    okbits = torch.zeros(r.shape, dtype=torch.int32, device=r.device)
    for k, q1k in enumerate(q1s):
        q2k = q1k + width
        left_ok = (dc + q1k) < gend
        fit_ok = torch.where(s_local == 0, fit_pos0, fit_norm) if q1k == 0 else fit_norm
        wmask = _nibble_mask(q2k - wordbase) & ~_nibble_mask(q1k - wordbase)
        win_mm = popcount32(nz & wmask[None, :]).sum(dim=1)
        bit = left_ok & fit_ok & (win_mm == 0)
        okbits = okbits | (bit.to(torch.int32) << k)

    okbits = torch.where(active & budget_ok, okbits, 0)
    return nx, s_local.to(torch.int32), okbits


def _tile(query: str, *shape, lib=None) -> tuple[int, int]:
    """Launcher ``muscato_<query>``'s answer for ``shape`` on the current
    CUDA device: (lanes, shared memory bytes)."""
    lanes, smem = ctypes.c_int(), ctypes.c_longlong()
    rc = getattr(lib or _lib.kernels().lib, "muscato_" + query)(
        *shape, ctypes.byref(lanes), ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(f"{query}: CUDA error {rc}")
    return lanes.value, smem.value


def swar_tile(nwords: int, tcols: int, lib=None) -> tuple[int, int]:
    """The tile the B7 kernel of ``lib`` (default: the kernel library)
    takes on the current CUDA device for reads of ``nwords`` words and
    t_rows of ``tcols`` words: (lanes, shared memory bytes); 0 bytes is
    the direct route, one thread a lane with no shared memory, which a
    shape takes when not even 32 lanes of it fit in shared memory.  Asked
    of the library, which alone knows the tile's layout."""
    return _tile("verify_tile", nwords, tcols, lib=lib)


def pairs_tile(nwords: int, lib=None) -> tuple[int, int]:
    """B10's tile for reads of ``nwords`` words, as ``swar_tile`` gives
    B7's: a warp of 32 lanes staged in shared memory, or 0 bytes for the
    direct route (reads past ~907 words on an H100)."""
    return _tile("verify_pairs_tile", nwords, lib=lib)


@functools.lru_cache(maxsize=None)
def direct_route(kernel: str, device: int, nwords: int, tcols: int = 0) -> bool:
    """True when the kernel library's B7 (``verify_diagonals``) or B10
    (``verify_pairs``) launches its direct kernel for this shape on CUDA
    device ``device``: the wrappers count those launches apart, in
    ``direct_launches``."""
    with torch.cuda.device(device):
        smem = (swar_tile(nwords, tcols) if kernel == "verify_diagonals"
                else pairs_tile(nwords))[1]
    return smem == 0


def verify_diagonals_swar(r, d, t_rows, rpacked, lengths, gstart, gend, budget, q1s, *,
                          width: int, smax: int):
    """The SWAR body of the dedup verify over (C,) lanes: launches the CUDA
    kernel in ``csrc/verify.cu`` (the body of
    ``muscato_tpu/ops/packed.py:verify_diagonals_packed``, which XLA fuses;
    it has no Pallas kernel).  ``t_rows`` (C, >= nwords + 8) holds each
    lane's target row (``diagonal_fetch``), ``gstart`` and ``gend`` its
    gene's bounds.  Returns (nx, s, okbits), each (C,) int32; see
    ``verify_diagonals_packed``."""
    if _lib.on_cpu("verify_diagonals_swar", r, d, t_rows, rpacked, lengths, gstart,
                   gend, budget):
        return verify_diagonals_swar_torch(r, d, t_rows, rpacked, lengths, gstart, gend,
                                           budget, q1s, width=width, smax=smax)
    n = r.shape[0]
    if any(t.shape[0] != n for t in (d, t_rows, gstart, gend)):
        raise ValueError("verify_diagonals_swar: lane shapes disagree")
    nx, s, okbits = (torch.empty(n, dtype=torch.int32, device=r.device) for _ in range(3))
    if n:
        # The launcher refuses more than 32 windows, t_rows narrower than
        # nwords + 8 words and empty tables; the launch then raises.
        _lib.launch(
            "verify_diagonals", r, r.data_ptr(), d.data_ptr(), n, t_rows.data_ptr(),
            t_rows.shape[1], rpacked.data_ptr(), *rpacked.shape, lengths.data_ptr(),
            gstart.data_ptr(), gend.data_ptr(), budget.data_ptr(), budget.numel(),
            (ctypes.c_int * max(len(q1s), 1))(*q1s), len(q1s), width, smax,
            nx.data_ptr(), s.data_ptr(), okbits.data_ptr(),
        )
        verify_diagonals_swar.launches += 1
        if direct_route("verify_diagonals", r.device.index, rpacked.shape[1], t_rows.shape[1]):
            verify_diagonals_swar.direct_launches += 1
    return nx, s, okbits


verify_diagonals_swar.launches = 0
verify_diagonals_swar.direct_launches = 0  # of those, on the direct route


def verify_diagonals_packed(
    r: torch.Tensor,  # (C,) int32 read rows (-1 = inactive lane)
    d: torch.Tensor,  # (C,) int32 global read-start positions (diagonals)
    rpacked: torch.Tensor,  # (R, NW) int32 nibble-packed reads
    lengths: torch.Tensor,  # (R,) int32
    gene_start: torch.Tensor,  # (G+1,) int32
    budget: torch.Tensor,  # (max_read_length+1,) int32
    q1s: tuple,  # (K,) window offsets, host ints
    width: int,
    smax: int,
    trows: torch.Tensor,  # (T, NW+9) int32 target-row view
    gblock: torch.Tensor,  # gene block table
    gsteps: int,
):
    """Verify one (read, diagonal) once for all windows at once (the
    diagonal-major branch of the JAX function: lanes sorted by (d, r), so
    the target-row and gene streams are monotone and ride B4 and B3; the
    SWAR body is ``verify_diagonals_swar``).

    Returns (nx, g, s, okbits): bit k of okbits says "a pair from window k
    on this diagonal passes verification" (window region exact, left and
    fit checks including the reference's pos-0 quirk, mismatch budget)."""
    g, gstart, gend, t_rows = diagonal_fetch(r, d, gene_start, gblock, gsteps, trows, smax)
    nx, s, okbits = verify_diagonals_swar(r, d, t_rows, rpacked, lengths, gstart, gend,
                                          budget, q1s, width=width, smax=smax)
    return nx, g.to(torch.int32), s, okbits


def verify_pairs_packed_torch(r, p, rpacked, lengths, gene_start, budget, q1, width: int,
                              max_read_length: int, smax: int, trows, gblock, gsteps: int):
    """Plain twin of ``verify_pairs_packed``: the JAX function's steps as
    int64 tensor passes, with the row and gene fetches by plain indexing."""
    nwords = rpacked.shape[1]
    active = (r >= 0) & (p >= 0)
    rc = r.clamp(0, rpacked.shape[0] - 1).long()
    pc = p.clamp(0, smax - 1)
    q1 = torch.as_tensor(q1, dtype=torch.int32, device=r.device).expand(r.shape)

    g = gene_of_pos_block(gene_start, gblock, pc, gsteps)
    gstart = gene_start[g.long()]
    glen = gene_start[(g + 1).long()] - gstart
    p_local = pc - gstart
    rlen = lengths[rc]

    s_local = p_local - q1
    left_ok = s_local >= 0
    # Right-tail fit with the reference's pos-0 cap quirk: here the quirk
    # keys on the window position, not on the read start.
    q2 = q1 + width
    cap_norm = p_local + width + (max_read_length - q2)
    is_pos0 = (p_local == 0) & (q1 == 0)
    cap_abs = torch.where(is_pos0, 100 - q2, cap_norm)
    fit_ok = (rlen - q2) <= torch.minimum(glen, cap_abs) - (p_local + width)

    # ---- SWAR mismatch count over the aligned diagonal ----
    dc = (pc - q1).clamp(min=0)
    rshift = ((dc & 7) * 4).to(torch.int64)[:, None]
    tw = u64(_trows_fetch(trows, dc, nwords))
    lowpart = tw[:, :-1] >> rshift
    hipart = torch.where(
        rshift == 0, 0, (tw[:, 1:] << ((32 - rshift) & 31)) & M32
    )
    x = (lowpart | hipart) ^ u64(rpacked[rc])
    wordbase = torch.arange(nwords, dtype=torch.int64, device=r.device) * BASES_PER_WORD
    x = x & _nibble_mask(rlen[:, None].to(torch.int64) - wordbase[None, :])
    nz = (x | (x >> 1) | (x >> 2) | (x >> 3)) & _NIB1
    nx = popcount32(nz).sum(dim=1).to(torch.int32)

    q1w = q1.to(torch.int64)[:, None] - wordbase[None, :]
    win_mask = _nibble_mask(q1w + width) & ~_nibble_mask(q1w)
    win_mm = popcount32(nz & win_mask).sum(dim=1)

    keep = (
        active & left_ok & fit_ok & (win_mm == 0)
        & (nx <= budget[rlen.clamp(0, budget.shape[0] - 1).long()])
    )
    return keep, nx, g.to(torch.int32), s_local.to(torch.int32)


def verify_pairs_packed(
    r: torch.Tensor,  # (P,) int32 read rows (-1 = inactive lane)
    p: torch.Tensor,  # (P,) int32 global window positions (-1 = inactive)
    rpacked: torch.Tensor,  # (R, NW) int32 nibble-packed reads
    lengths: torch.Tensor,  # (R,) int32
    gene_start: torch.Tensor,  # (G+1,) int32
    budget: torch.Tensor,  # (max_read_length+1,) int32
    q1,  # int or (P,) int32: the window offset of each pair lane
    width: int,
    max_read_length: int,
    smax: int,
    trows: torch.Tensor,  # (T, NW+9) int32 target-row view
    gblock: torch.Tensor,  # gene block table
    gsteps: int,
):
    """Verify one (read, window position) pair a lane, each with its own
    window offset q1: launches B10, the CUDA kernel in ``csrc/verify.cu``
    (each warp's read rows and target windows staged in shared memory, or
    for reads too long for that a thread a lane reading global memory; the
    body of ``muscato_tpu/ops/packed.py:verify_pairs_packed``, which
    XLA fuses; it has no Pallas kernel); on CPU tensors its plain twin
    ``verify_pairs_packed_torch``.  Returns (keep, nx, g, s): keep (bool)
    says the pair passes (window region exact, left and right-tail fit
    including the reference's pos-0 cap quirk, mismatch budget); s is the
    read start in the gene; nx, g and s are int32."""
    q1v = q1.expand(r.shape).contiguous() if torch.is_tensor(q1) else None
    tensors = (r, p, rpacked, lengths, gene_start, budget, trows, gblock)
    if _lib.on_cpu("verify_pairs_packed", *tensors, *([] if q1v is None else [q1v])):
        return verify_pairs_packed_torch(r, p, rpacked, lengths, gene_start, budget, q1,
                                         width, max_read_length, smax, trows, gblock, gsteps)
    n = r.shape[0]
    if p.shape[0] != n:
        raise ValueError("verify_pairs_packed: lane shapes disagree")
    keep = torch.empty(n, dtype=torch.bool, device=r.device)
    nx, g, s = (torch.empty(n, dtype=torch.int32, device=r.device) for _ in range(3))
    if n:
        # The launcher refuses trows narrower than nwords + 8 words and
        # empty tables; the launch then raises.
        _lib.launch(
            "verify_pairs", r, r.data_ptr(), p.data_ptr(), n,
            None if q1v is None else q1v.data_ptr(), int(q1) if q1v is None else 0,
            trows.data_ptr(), *trows.shape, rpacked.data_ptr(), *rpacked.shape,
            lengths.data_ptr(), gene_start.data_ptr(), gene_start.numel(), gblock.data_ptr(),
            gblock.numel(), gsteps, budget.data_ptr(), budget.numel(), width,
            max_read_length, smax, keep.data_ptr(), nx.data_ptr(), g.data_ptr(), s.data_ptr(),
        )
        verify_pairs_packed.launches += 1
        if direct_route("verify_pairs", r.device.index, rpacked.shape[1]):
            verify_pairs_packed.direct_launches += 1
    return keep, nx, g, s


verify_pairs_packed.launches = 0
verify_pairs_packed.direct_launches = 0  # of those, on the direct route
