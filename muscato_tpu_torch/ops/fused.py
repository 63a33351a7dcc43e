"""The matching stages of one read batch (port of ``muscato_tpu/ops/fused.py``).

Each batch runs four stages on the device, each ported from the JAX
function named in its docstring:

  probe    B5 window keys of every (window, read), a query sort, the B1
           sorted join against the resident index, and a compaction in lo
           order (or, with MUSCATO_PJOIN=0, the sort-merge probe: one sort
           of index and query keys together, no B1);
  expand   B2 pair expansion (B6 with MUSCATO_PEXPAND_SUB=1), the B3
           postings fetch, the (diagonal, read) pair sort and the
           unique-(read, diagonal) compaction;
  verify   the SWAR verify over the unique diagonals in chunks (B4 target
           rows, B3 gene lookup), the B3 verdict map-back over ``u_idx``,
           the survivor sort and the B3 cap-key fetch;
  rank     MaxMatches cap, (read, gene, start) dedup and per-read
           best+MMTol over the survivors, with a B3 segment-min broadcast.

The JAX package's main-path configuration is the default: the pjoin probe,
PEXPAND, MGATHER and DORDER, which on the GPU are simply the way the stage
runs.  The engine takes the sort-merge probe and the B6 expand on the JAX
package's own switches.  The GPU kernels have no windows, so nothing here
can overflow and no fallback ladder exists.

uint32 values (window keys, packed words) are held as int32 bit patterns;
``lax.sort`` with several keys becomes packed int64 keys or stable LSD
passes of ``torch.sort``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import join as _join
from .expand import expand_owners
from .gather import monotone_gather
from .packed import M32, to_i32, u64, verify_diagonals_packed
from .window_queries import window_queries

NCOL = 7  # r, g, s, nx, group1, group2, window
INF32 = 0x7FFFFFFF
_TWO32 = 1 << 32
_TWO31 = 1 << 31


def _cat_first(x: torch.Tensor) -> torch.Tensor:
    """[True, x...] — run-start flags from an adjacent-difference mask."""
    return torch.cat([torch.ones(1, dtype=torch.bool, device=x.device), x])


def _key_s(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int64 whose signed order is the lexicographic signed-int32 order of
    (a, b)."""
    return a.to(torch.int64) * _TWO32 + (b.to(torch.int64) + _TWO31)


def _key_u(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int64 whose signed order is the lexicographic unsigned order of
    (a, b), both int64 values in [0, 2**32)."""
    return (a - _TWO31) * _TWO32 + b


def _lexsort(keys) -> torch.Tensor:
    """Permutation sorting by int64 ``keys`` (most significant first): one
    stable ``torch.sort`` pass per key, least significant first."""
    perm = None
    for k in reversed(keys):
        kk = k if perm is None else k[perm]
        _, idx = torch.sort(kk, stable=True)
        perm = idx if perm is None else perm[idx]
    return perm


# ---- probe ---------------------------------------------------------------


class Probe(NamedTuple):
    counts: torch.Tensor  # (K*R,) candidate count of the query at each slot
    lo: torch.Tensor  # start of the query's postings run in the index
    qid: torch.Tensor  # flat (window*R + read) query id, -1 = inactive
    keyf: torch.Tensor  # (K*R,) key1 of every query, in qid order
    key2f: torch.Tensor  # (K*R,) key2 of every query, in qid order
    total: torch.Tensor  # 0-d int64: exact candidate pair count


def _probe_windows_pjoin_impl(rpacked, lengths, q1s, skeys, *, width, min_dinuc):
    """Sorted-join probe (port of ``fused._probe_windows_pjoin_impl``):
    sort the queries, resolve lo/count per query against the sorted index
    with B1, then compact to the active slots in lo order — which makes
    the expansion's postings index stream piecewise monotone."""
    nflat = len(q1s) * rpacked.shape[0]
    if nflat >= (1 << 30) - 1:
        raise ValueError("query space exceeds the packed-key range")
    if skeys.shape[0] >= (1 << 30):
        raise ValueError("index exceeds the packed-lo range")
    keyf, key2f, validf = window_queries(
        rpacked, lengths, q1s, width=width, min_dinuc=min_dinuc
    )
    dev = rpacked.device
    qid_pay = torch.where(
        validf, torch.arange(nflat, dtype=torch.int32, device=dev), -1
    )
    ks_flip, order = torch.sort(_join.flip(keyf))
    qid_m = qid_pay[order]
    lo_m, counts_m, _ = _join.sorted_join(skeys, _join.flip(ks_flip))
    counts_m = torch.where(qid_m >= 0, counts_m, 0)
    total = counts_m.sum(dtype=torch.int64)
    inactive = (counts_m == 0).to(torch.int32)
    packed_key = (inactive << 30) | lo_m.clamp(0, (1 << 30) - 1)
    packed_c, order = torch.sort(packed_key)
    return Probe(
        counts=counts_m[order], lo=packed_c & ((1 << 30) - 1),
        qid=qid_m[order], keyf=keyf, key2f=key2f, total=total,
    )


def _probe_windows_impl(rpacked, lengths, q1s, skeys, *, width, min_dinuc):
    """Sort-merge probe (port of ``fused._probe_windows_impl``): one stable
    sort of the index keys and the query keys together, on key1 alone.
    Index rows precede equal-key queries (they come first in the
    concatenation), so a query's candidate count is the number of index
    rows in its key's run and its lo the number of index rows before the
    run; then the same lo-ordered compaction as the sorted-join probe,
    over V + Q rows, of which the first Q slots are kept."""
    nflat = len(q1s) * rpacked.shape[0]
    nidx = skeys.shape[0]
    if nflat >= (1 << 30) - 1:
        raise ValueError("query space exceeds the packed-key range")
    if nidx >= (1 << 30):
        raise ValueError("index exceeds the packed-lo range")
    keyf, key2f, validf = window_queries(
        rpacked, lengths, q1s, width=width, min_dinuc=min_dinuc
    )
    dev = rpacked.device
    # The payload word encodes the row class: -1 an index row, >= 0 a valid
    # query (its flat id), -2 a length- or entropy-rejected query.
    pay = torch.cat([
        torch.full((nidx,), -1, dtype=torch.int32, device=dev),
        torch.where(validf, torch.arange(nflat, dtype=torch.int32, device=dev), -2),
    ])
    # Each intermediate below spans V + Q rows (0.5-1 GB at the flagship)
    # and is dropped as soon as it is used, to bound peak memory.
    m1s, order = torch.sort(_join.flip(torch.cat([skeys, keyf])), stable=True)
    pay_s = pay[order]
    del order
    seg = _cat_first(m1s[1:] != m1s[:-1])
    del m1s
    is_idx = (pay_s == -1).to(torch.int64)
    ie = torch.cumsum(is_idx, 0) - is_idx  # index rows strictly before j
    del is_idx
    seg_ie = torch.cummax(torch.where(seg, ie, -1), 0).values  # ie at my run start
    del seg
    counts_m = torch.where(pay_s >= 0, ie - seg_ie, 0).to(torch.int32)
    del ie
    lo_m = seg_ie.clamp(min=0)
    qid_m = torch.where(pay_s >= 0, pay_s, -1)
    inactive = (counts_m == 0).to(torch.int64)
    packed_key = (inactive << 30) | lo_m.clamp(0, (1 << 30) - 1)
    packed_c, order = torch.sort(packed_key.to(torch.int32))
    order = order[:nflat]
    counts_c = counts_m[order]
    return Probe(
        counts=counts_c, lo=packed_c[:nflat] & ((1 << 30) - 1),
        qid=qid_m[order], keyf=keyf, key2f=key2f,
        total=counts_c.sum(dtype=torch.int64),
    )


# ---- expand --------------------------------------------------------------


class Pairs(NamedTuple):
    qid_s: torch.Tensor  # (pair_cap,) flat query id per pair, (d, r)-sorted; -1 = inactive
    u_idx: torch.Tensor  # index of the pair's unique (r, d) in (ur, ud)
    ur: torch.Tensor  # compacted unique read rows (prefix of nuniq, then -1)
    ud: torch.Tensor  # compacted unique diagonals (prefix of nuniq, then 0)
    nuniq: torch.Tensor  # 0-d
    total: torch.Tensor  # 0-d int64 exact pair count


def _expand_pairs_impl(counts_m, lo_m, qid_m, q1s, spos, *, nreads, pair_cap,
                       smax, subchunk=False):
    """Pair expansion into a (pair_cap,) buffer sorted by (diagonal, read)
    with run-start bookkeeping for the diagonal-dedup verify (port of
    ``fused._expand_pairs_impl`` with pexpand, mgather and dorder on):
    B2 (B6 with ``subchunk``) finds each lane's owning slot, B3 fetches its
    postings site.  As in the JAX function, smax=None keeps the qid payload
    through the sort instead of packing the window index into the minor
    key."""
    dev = counts_m.device
    offsets = torch.cumsum(counts_m, 0)
    total = offsets[-1]
    oexcl = (offsets - counts_m).to(torch.int32)

    pid = torch.arange(pair_cap, dtype=torch.int32, device=dev)
    qid, sidx0 = expand_owners(oexcl, lo_m, qid_m, pair_cap=pair_cap,
                               subchunk=subchunk)
    sidx = sidx0.clamp(0, spos.shape[0] - 1)
    act = (pid < total) & (qid >= 0)
    qpos = qid.clamp(min=0)
    k_lane = qpos // nreads
    r_lane = qpos - k_lane * nreads
    site, _ = monotone_gather(spos, sidx)
    q1t = torch.tensor(q1s, dtype=torch.int32, device=dev)
    d = site - q1t[k_lane.long()]

    # The window index k rides the minor key's low bits when (r, k) fits
    # int32, and the qid payload disappears; inactive lanes key to int32-max
    # and sink to the end.
    nwin = len(q1s)
    kbits = max((nwin - 1).bit_length(), 1)
    kmax = (1 << kbits) - 1
    packk = smax is not None and ((nreads << kbits) | kmax) < INF32
    dkey = torch.where(act, d, INF32)
    rkey = torch.where(act, r_lane, INF32)
    if packk:
        minor = torch.where(act, (r_lane << kbits) | k_lane, INF32)
        key, _ = torch.sort(dkey.to(torch.int64) * _TWO32 + minor)
        d_s = (key >> 32).to(torch.int32)
        minor_s = (key & M32).to(torch.int32)
        act_s = d_s != INF32
        run_min = minor_s >> kbits
        r_s = torch.where(act_s, run_min, -1)
        k_s = torch.where(act_s, minor_s & kmax, 0)
        qid_s = torch.where(act_s, k_s * nreads + r_s.clamp(min=0), -1)
    else:
        qid_pay = torch.where(act, qid, -1)
        key, order = torch.sort(_key_s(dkey, rkey))
        d_s = (key >> 32).to(torch.int32)
        run_min = ((key & M32) - _TWO31).to(torch.int32)
        act_s = d_s != INF32
        r_s = torch.where(act_s, run_min, -1)
        qid_s = qid_pay[order]
    d_s = torch.where(act_s, d_s, 0)

    run_start = _cat_first(
        (d_s[1:] != d_s[:-1]) | (run_min[1:] != run_min[:-1])
    ) & act_s
    u_idx = (torch.cumsum(run_start, 0) - 1).to(torch.int32)
    nuniq = u_idx[-1] + 1
    # Stable compaction of the run starts to a prefix: each run start's
    # u_idx is its unique target; other lanes go to a dump slot past the end.
    tgt = torch.where(run_start, u_idx, pair_cap).long()
    ur = torch.full((pair_cap + 1,), -1, dtype=torch.int32, device=dev)
    ud = torch.zeros(pair_cap + 1, dtype=torch.int32, device=dev)
    ur[tgt] = r_s
    ud[tgt] = d_s
    return Pairs(qid_s, u_idx, ur[:pair_cap], ud[:pair_cap], nuniq, total)


# ---- verify + tail -------------------------------------------------------


class Verified(NamedTuple):
    qd: torch.Tensor  # (pair_cap,) survivor qids ascending, then int32-max
    vals: tuple  # per pair lane: (g<<xbits|nx, s) or (nx, g, s)
    order: torch.Tensor  # permutation of the pair lanes that sorts qd
    last_live: torch.Tensor  # 0-d: the largest survivor qid (0 if none)
    nsurv: torch.Tensor  # 0-d int64 survivor count
    xbits: int
    pack_gnx: bool


def _verify_diagonals(pairs: Pairs, q1s, rpacked, lengths, gene_start, budget,
                      trows, gblock, *, nreads, width, max_read_length, vchunk,
                      smax, gsteps) -> Verified:
    """Chunked verify over the unique (r, d) prefix, verdict map-back to
    the pair lanes over ``u_idx`` (B3) and the survivor sort.  With
    ``survivor_rows``, which builds the survivor buffer for a given
    capacity, this is ``fused._verify_diagonals_impl``."""
    qid_s, u_idx, ur, ud = pairs.qid_s, pairs.u_idx, pairs.ur, pairs.ud
    cap = ur.shape[0]
    nwin = len(q1s)
    dev = ur.device
    # (g, nx) share one word when the widths fit (nx <= max_read_length).
    xbits = max(int(max_read_length).bit_length(), 1)
    ngenes = int(gene_start.shape[0]) - 1
    pack_gnx = ((ngenes << xbits) | ((1 << xbits) - 1)) < INF32
    nval = 2 if pack_gnx else 3
    ur_p = torch.cat([ur, torch.full((vchunk,), -1, dtype=torch.int32, device=dev)])
    ud_p = torch.cat([ud, torch.zeros(vchunk, dtype=torch.int32, device=dev)])
    vb = [torch.zeros(cap + vchunk, dtype=torch.int32, device=dev) for _ in range(nval)]
    okb = torch.zeros(cap + vchunk, dtype=torch.int32, device=dev)

    nuniq = int(pairs.nuniq)
    for off in range(0, nuniq, vchunk):
        nx, g, s, ok = verify_diagonals_packed(
            ur_p[off : off + vchunk], ud_p[off : off + vchunk], rpacked,
            lengths, gene_start, budget, q1s, width, smax, trows, gblock,
            gsteps,
        )
        vals = ((g << xbits) | nx, s) if pack_gnx else (nx, g, s)
        for buf, v in zip(vb, vals):
            buf[off : off + vchunk] = v
        okb[off : off + vchunk] = ok

    # Verdict bits and values map back to the pair lanes before the
    # compaction: u_idx is nondecreasing, so these are monotone B3 streams.
    uix = u_idx.clamp(0, cap - 1)
    kc = (qid_s.clamp(min=0) // nreads).clamp(0, nwin - 1)
    okw, _ = monotone_gather(okb, uix)
    keep = (qid_s >= 0) & (((okw >> kc) & 1) == 1)
    valw = tuple(monotone_gather(b, uix)[0] for b in vb)

    # Survivors first: dead lanes key to int32-max.
    qd, order = torch.sort(torch.where(keep, qid_s, INF32))
    last_live = torch.where(keep, qid_s, 0).max()
    return Verified(
        qd=qd, vals=valw, order=order, last_live=last_live,
        nsurv=keep.sum(dtype=torch.int64), xbits=xbits, pack_gnx=pack_gnx,
    )


def survivor_rows(ver: Verified, keyf, key2f, *, nreads, nwin, surv_cap):
    """The (surv_cap, NCOL) survivor buffer (read, gene, start, nmiss,
    group1, group2, window) from a verify result — the tail of
    ``fused._verify_diagonals_impl``; the cap-group keys are fetched by B3
    over the ascending survivor qids."""
    cap = ver.qd.shape[0]
    take = min(surv_cap, cap)
    qdt = ver.qd[:take]
    sel = ver.order[:take]
    valt = [v[sel] for v in ver.vals]
    if ver.pack_gnx:
        gnx_t, s2 = valt
        nx2 = gnx_t & ((1 << ver.xbits) - 1)
        g2 = (u64(gnx_t) >> ver.xbits).to(torch.int32)
    else:
        nx2, g2, s2 = valt
    kt = (qdt.clamp(min=0) // nreads).clamp(0, nwin - 1)
    rt = qdt.clamp(min=0) - kt * nreads
    # Dead tail lanes clamp to the last live qid so the key fetch stays
    # monotone through the tail.
    nflat = keyf.shape[0]
    qc = torch.minimum(qdt, ver.last_live).clamp(0, nflat - 1)
    gr1, _ = monotone_gather(keyf, qc)
    gr2, _ = monotone_gather(key2f, qc)
    surv = torch.zeros((surv_cap, NCOL), dtype=torch.int32, device=qdt.device)
    surv[:take] = torch.stack([rt, g2, s2, nx2, gr1, gr2, kt], dim=1)
    return surv


def expand_verify_dedup(pr: Probe, q1s, rpacked, lengths, spos, gene_start,
                        budget, *, width, max_read_length, pair_cap, vchunk,
                        smax, trows, gblock, gsteps, subchunk=False) -> Verified:
    """Expand + verify of one batch up to the survivor sort; the caller
    sizes the survivor buffer from ``nsurv`` and calls ``survivor_rows``.
    ``subchunk`` runs the expansion on B6 instead of B2."""
    q1s = tuple(q1s)
    nreads = rpacked.shape[0]
    pairs = _expand_pairs_impl(
        pr.counts, pr.lo, pr.qid, q1s, spos, nreads=nreads,
        pair_cap=pair_cap, smax=smax, subchunk=subchunk,
    )
    return _verify_diagonals(
        pairs, q1s, rpacked, lengths, gene_start, budget, trows, gblock,
        nreads=nreads, width=width, max_read_length=max_read_length,
        vchunk=vchunk, smax=smax, gsteps=gsteps,
    )


# ---- rank ----------------------------------------------------------------


def _pack64_fields(fields, bits):
    """LSB-first pack of nonnegative int32 fields into (lo, hi) 32-bit
    words held as int64; unsigned comparison of (hi, lo) is lexicographic
    comparison of the fields MSB-first (i.e. reversed(fields))."""
    lo = torch.zeros(fields[0].shape, dtype=torch.int64, device=fields[0].device)
    hi = torch.zeros_like(lo)
    pos = 0
    for v, b in zip(fields, bits):
        vu = v.to(torch.int64) & (((1 << b) - 1) if b < 32 else M32)
        if pos < 32:
            lo = lo | ((vu << pos) & M32)
            if pos + b > 32:
                hi = hi | (vu >> (32 - pos))
        else:
            hi = hi | ((vu << (pos - 32)) & M32)
        pos += b
    return lo, hi


def _extract64(lo, hi, pos, b):
    """Field extraction from _pack64_fields words; pos and b static."""
    if pos >= 32:
        w = hi >> (pos - 32)
    else:
        w = lo >> pos
        if pos + b > 32:
            w = w | ((hi << (32 - pos)) & M32)
    if b < 32:
        w = w & ((1 << b) - 1)
    return to_i32(w & M32)


def _pack_rows64(r, g, s, nx, pack_bits):
    """(r, g, s, nx) -> (n, 2) int32 lo/hi words, LSB-first (nx, s, g, r)."""
    rb, gb, sb, xb = pack_bits
    lo, hi = _pack64_fields((nx, s, g, r), (xb, sb, gb, rb))
    return torch.stack([to_i32(lo), to_i32(hi)], dim=1)


def _seg_min_broadcast(nxm, seg_id, n):
    """Per-segment min of nxm broadcast back to every lane.  seg_id is
    dense and nondecreasing, so the broadcast is a monotone B3 gather."""
    table = torch.full((n,), INF32, dtype=torch.int32, device=nxm.device)
    table = table.scatter_reduce(
        0, seg_id.long(), nxm, reduce="amin", include_self=False
    )
    best, _ = monotone_gather(table, seg_id)
    return best


def _rank_core_packed(buf, live, mm, mmtol, *, match_mode, pack_bits):
    """Port of ``fused._rank_core_packed``: cap, dedup and best+MMTol with
    (r, g, s, nx) packed into 64-bit words through every sort.  Returns
    ((n, 2) int32 lo/hi rows — retained prefix in canonical (r, g, s)
    order — and the retained count)."""
    rb, gb, sb, xb = pack_bits
    n = buf.shape[0]
    r, g, s, nx, grp, grp2, win = buf.unbind(1)
    dead = (~live).to(torch.int64)
    iota = torch.arange(n, dtype=torch.int64, device=buf.device)

    # 1. MaxMatches cap per (window, key1, key2) group; in-group order is
    #    (nx, g, s, r) for best, (g, s, r, nx) for first.
    dw = (dead << 16) | win.to(torch.int64)
    if match_mode == "first":
        lo1, hi1 = _pack64_fields((nx, r, s, g), (xb, rb, sb, gb))
    else:
        lo1, hi1 = _pack64_fields((r, s, g, nx), (rb, sb, gb, xb))
    grp_u, grp2_u = u64(grp), u64(grp2)
    perm = _lexsort([dw * _TWO32 + grp_u, _key_u(grp2_u, hi1), lo1])
    dw, grp_u, grp2_u, hi1, lo1 = (t[perm] for t in (dw, grp_u, grp2_u, hi1, lo1))
    newgrp = _cat_first(
        (dw[1:] != dw[:-1]) | (grp_u[1:] != grp_u[:-1]) | (grp2_u[1:] != grp2_u[:-1])
    )
    seg_start = torch.cummax(torch.where(newgrp, iota, 0), 0).values
    cap = mm + (1 if match_mode == "first" else 0)
    keep = (dw < (1 << 16)) & ((iota - seg_start) < cap)

    # 2. exact dedup on (read, gene, start), canonical order; nx rides in
    #    the low bits (a function of (r, g, s)).
    if match_mode == "first":
        nx2, r2, s2, g2 = (_extract64(lo1, hi1, p, b) for p, b in
                           ((0, xb), (xb, rb), (xb + rb, sb), (xb + rb + sb, gb)))
    else:
        r2, s2, g2, nx2 = (_extract64(lo1, hi1, p, b) for p, b in
                           ((0, rb), (rb, sb), (rb + sb, gb), (rb + sb + gb, xb)))
    loc, hic = _pack64_fields((nx2, s2, g2, r2), (xb, sb, gb, rb))
    dead2 = (~keep).to(torch.int64)
    perm = _lexsort([dead2 * _TWO32 + hic, loc])
    dead2, hic, loc = dead2[perm], hic[perm], loc[perm]
    first_rgs = _cat_first((hic[1:] != hic[:-1]) | (loc[1:] != loc[:-1]))
    keep = (dead2 == 0) & first_rgs

    # 3. per-read best + MMTol (segment-min over the established order).
    nx3 = _extract64(loc, hic, 0, xb)
    r3 = _extract64(loc, hic, xb + sb + gb, rb)
    nxm = torch.where(keep, nx3, INF32)
    new_read = _cat_first((r3[1:] != r3[:-1]) | (dead2[1:] != dead2[:-1]))
    seg_id = (torch.cumsum(new_read, 0) - 1).to(torch.int32)
    best = _seg_min_broadcast(nxm, seg_id, n)
    keep = keep & (nxm.to(torch.int64) <= best.to(torch.int64) + mmtol)

    # 4. stable single-key compaction; the packed words are the return.
    _, perm = torch.sort((~keep).to(torch.int32), stable=True)
    rows = torch.stack([to_i32(loc[perm]), to_i32(hic[perm])], dim=1)
    return rows, keep.sum(dtype=torch.int64)


def _rank_core(buf, live, mm, mmtol, *, match_mode, full_cols=True,
               pack_bits=None):
    """Port of ``fused._rank_core``: the unpacked rank, which the
    multi-batch path uses with full_cols (the group columns come back for
    the cross-batch re-cap).  Returns (rows, retained count)."""
    if pack_bits is not None and not full_cols:
        return _rank_core_packed(
            buf, live, mm, mmtol, match_mode=match_mode, pack_bits=pack_bits
        )
    n = buf.shape[0]
    r, g, s, nx, grp, grp2, win = buf.unbind(1)
    dead = (~live).to(torch.int32)
    iota = torch.arange(n, dtype=torch.int64, device=buf.device)

    # 1. MaxMatches cap per (window, key1, key2) group
    #    ('first' emits MaxMatches+1 like the reference's append-then-check).
    if match_mode == "first":
        ops = (dead, win, grp, grp2, g, s, r, nx)
    else:
        ops = (dead, win, grp, grp2, nx, g, s, r)
    perm = _lexsort([_key_s(ops[i], ops[i + 1]) for i in range(0, 8, 2)])
    dead_s, win, grp, grp2, g, s, r, nx = (
        t[perm] for t in (dead, win, grp, grp2, g, s, r, nx)
    )
    newgrp = _cat_first(
        (win[1:] != win[:-1]) | (grp[1:] != grp[:-1]) | (grp2[1:] != grp2[:-1])
    )
    seg_start = torch.cummax(torch.where(newgrp, iota, 0), 0).values
    cap = mm + (1 if match_mode == "first" else 0)
    keep = (dead_s == 0) & ((iota - seg_start) < cap)
    extras = (grp, grp2, win) if full_cols else ()

    # 2. exact dedup on (read, gene, start); establishes the final order.
    dead2 = (~keep).to(torch.int32)
    perm = _lexsort([_key_s(dead2, r), _key_s(g, s)])
    dead2, r, g, s, nx = (t[perm] for t in (dead2, r, g, s, nx))
    extras = tuple(t[perm] for t in extras)
    first_rgs = _cat_first(
        (r[1:] != r[:-1]) | (g[1:] != g[:-1]) | (s[1:] != s[:-1])
    )
    keep = (dead2 == 0) & first_rgs

    # 3. per-read best + MMTol as a segment-min over that order.
    nxm = torch.where(keep, nx, INF32)
    new_read = _cat_first((r[1:] != r[:-1]) | (dead2[1:] != dead2[:-1]))
    seg_id = (torch.cumsum(new_read, 0) - 1).to(torch.int32)
    best = _seg_min_broadcast(nxm, seg_id, n)
    keep = keep & (nxm.to(torch.int64) <= best.to(torch.int64) + mmtol)

    # 4. stable compaction of the kept rows.
    _, perm = torch.sort((~keep).to(torch.int32), stable=True)
    r, g, s, nx = (t[perm] for t in (r, g, s, nx))
    extras = tuple(t[perm] for t in extras)
    if full_cols:
        rows = torch.stack([r, g, s, nx, *extras], dim=1)
    elif pack_bits is not None:
        rows = _pack_rows64(r, g, s, nx, pack_bits)
    else:
        rows = torch.stack([r, g, s, nx], dim=1)
    return rows, keep.sum(dtype=torch.int64)


def rank_survivors(buf, nsurv, mm, mmtol, *, match_mode, full_cols=True,
                   pack_bits=None):
    """Device-side cap + dedup + best+MMTol over one batch's survivor
    buffer, whose first ``nsurv`` rows are live."""
    live = torch.arange(buf.shape[0], device=buf.device) < nsurv
    return _rank_core(buf, live, mm, mmtol, match_mode=match_mode,
                      full_cols=full_cols, pack_bits=pack_bits)
