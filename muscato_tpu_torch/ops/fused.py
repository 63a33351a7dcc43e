"""The matching stages of one read batch (port of ``muscato_tpu/ops/fused.py``).

Each batch runs four stages on the device, each ported from the JAX
function named in its docstring:

  probe    B5 window keys of every (window, read), a query sort, the B1
           sorted join against the resident index, and a compaction in lo
           order (or, with MUSCATO_PJOIN=0, the sort-merge probe: one sort
           of index and query keys together, no B1; or, for an index much
           larger than the batch's queries, the search probe over the
           index's SearchAux: a direct bucket fetch, or a bucketed binary
           search for skewed keys, no B1);
  expand   B2 pair expansion (B6 with MUSCATO_PEXPAND_SUB=1), the B3
           postings fetch, the (diagonal, read) pair sort and the
           unique-(read, diagonal) compaction;
  verify   the SWAR verify over the unique diagonals in chunks (B4 target
           rows, B3 gene lookup), the B3 verdict map-back over ``u_idx``,
           the survivor sort and the B3 cap-key fetch;
  rank     MaxMatches cap, (read, gene, start) dedup and per-read
           best+MMTol over the survivors, with a B3 segment-min broadcast.

Where the dedup expand cannot run (NoDedup, more than 31 windows, or a
pair total above the engine's pair-buffer ceiling) the streaming stage
``expand_verify_streamed`` replaces expand and verify: fixed-size chunks
of pair lanes, each expanded by B2 (or B6) over its window of probe
slots, its postings fetched by B3 and each pair verified on its own, the
survivors appended to one buffer.

The JAX package's main-path configuration is the default: the pjoin probe,
PEXPAND, MGATHER and DORDER, which on the GPU are simply the way the stage
runs.  The engine takes the sort-merge probe and the B6 expand on the JAX
package's own switches.  A GPU kernel whose staged window does not fit
falls back to global memory inside the kernel, so nothing here can
overflow and no fallback ladder exists.

uint32 values (window keys, packed words) are held as int32 bit patterns;
``lax.sort`` with several keys becomes packed int64 keys or stable LSD
passes of ``torch.sort``.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from . import join as _join
from . import search as sops
from . import windows as winops
from .expand import expand_owners
from .gather import monotone_gather
from .packed import M32, to_i32, u64, verify_diagonals_packed, verify_pairs_packed
from .window_queries import window_queries

NCOL = 7  # r, g, s, nx, group1, group2, window
INF32 = 0x7FFFFFFF
_TWO32 = 1 << 32
_TWO31 = 1 << 31


def _no_span(name: str):
    """The default span of the probe and the rank: times nothing."""
    return contextlib.nullcontext()


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


def _forward_fill(flag: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """out[i] = v[j] for the last j <= i with flag[j]; flag[0] must be set.
    Where v never decreases over the flagged lanes this is the running max
    of where(flag, v, min), computed with no scan: each flagged lane
    writes its value at its group id (the other lanes at a dump slot past
    the end), and every lane reads its group's entry back by a monotone
    B3 gather.  v must fit int32."""
    n = flag.shape[0]
    gid = (torch.cumsum(flag, 0) - 1).to(torch.int32)
    tab = torch.zeros(n + 1, dtype=torch.int32, device=flag.device)
    tab[torch.where(flag, gid, n)] = v.to(torch.int32)
    out, _ = monotone_gather(tab, gid)
    return out


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


# Index windows below which the probes pack their (inactive, lo) compaction
# key into int32, as the JAX probes do; a larger index (a mesh shard holds
# up to 1.5e9 windows) takes an int64 key of the same order.  The int32
# key's sort keeps the probe stage about a quarter shorter on an H100
# (chip_smoke.py's lo_key_ab times both keys on each probe).
PACKED_LO_LIMIT = 1 << 30


def _lo_order(counts_m, lo_m, nidx: int):
    """(order, lo[order] as int32): the slots with a count first, in lo
    order, then the others (one sort of the packed key (inactive, lo),
    in int32 below PACKED_LO_LIMIT index windows, else in int64)."""
    inactive = counts_m == 0
    if nidx < PACKED_LO_LIMIT:
        lo = lo_m.clamp(0, (1 << 30) - 1).to(torch.int32)
        packed_c, order = torch.sort((inactive.to(torch.int32) << 30) | lo)
        return order, packed_c & ((1 << 30) - 1)
    packed_c, order = torch.sort(inactive.to(torch.int64) * _TWO32 + lo_m.clamp(min=0))
    return order, (packed_c & (_TWO32 - 1)).to(torch.int32)


def _probe_windows_pjoin_impl(rpacked, lengths, q1s, skeys, *, width, min_dinuc):
    """Sorted-join probe (port of ``fused._probe_windows_pjoin_impl``):
    sort the queries, resolve lo/count per query against the sorted index
    with B1, then compact to the active slots in lo order — which makes
    the expansion's postings index stream piecewise monotone."""
    nflat = len(q1s) * rpacked.shape[0]
    if nflat >= (1 << 30) - 1:
        raise ValueError("query space exceeds the packed-key range")
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
    order, lo_c = _lo_order(counts_m, lo_m, skeys.shape[0])
    return Probe(
        counts=counts_m[order], lo=lo_c, qid=qid_m[order], keyf=keyf, key2f=key2f,
        total=total,
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
    seg_ie = _forward_fill(seg, ie)  # ie at my run start
    del seg
    counts_m = torch.where(pay_s >= 0, ie - seg_ie, 0).to(torch.int32)
    del ie
    lo_m = seg_ie.clamp(min=0)
    qid_m = torch.where(pay_s >= 0, pay_s, -1)
    order, lo_c = _lo_order(counts_m, lo_m, nidx)
    order = order[:nflat]
    counts_c = counts_m[order]
    return Probe(
        counts=counts_c, lo=lo_c[:nflat], qid=qid_m[order], keyf=keyf, key2f=key2f,
        total=counts_c.sum(dtype=torch.int64),
    )


def _sorted_queries(rpacked, lengths, q1s, *, width, min_dinuc):
    """The search probes' query order: B5's window queries sorted by (key1,
    key2) as uint32, ties by qid (one stable sort of a packed int64 key, so
    the order is deterministic where the JAX sort leaves equal keys in no
    defined order).  Returns (keyf0, key2f0, validf) in qid order and
    (key1, key2, valid, qid) in sorted order."""
    keyf0, key2f0, validf0 = window_queries(
        rpacked, lengths, q1s, width=width, min_dinuc=min_dinuc
    )
    _, order = torch.sort(_key_u(u64(keyf0), u64(key2f0)), stable=True)
    return (keyf0, key2f0), (keyf0[order], key2f0[order], validf0[order],
                             order.to(torch.int32))


def _compact_lo_order(loc, counts, qid, keyf0, key2f0) -> Probe:
    """Active slots first, in lo order, the rest after (one stable sort
    keyed (inactive, lo)), as the JAX search probes compact them."""
    inactive = (counts == 0).to(torch.int64)
    _, order = torch.sort(inactive * _TWO32 + loc.to(torch.int64), stable=True)
    counts_c = counts[order]
    return Probe(
        counts=counts_c, lo=loc[order].to(torch.int32), qid=qid[order],
        keyf=keyf0, key2f=key2f0, total=counts_c.sum(dtype=torch.int64),
    )


def _probe_windows_direct_impl(rpacked, lengths, q1s, urec, sbucket, *, width,
                               min_dinuc, upshift, bucket_bits, bucket_width,
                               span=_no_span):
    """Direct-bucket probe (port of ``fused._probe_windows_direct_impl``):
    no bucket of the index's SearchAux holds more than ``bucket_width``
    distinct keys, so a query fetches its bucket's bounds and then the
    bucket's (k1, k2, start, count) records, with no search loop: B8,
    ``sops.direct_probe``, over the sorted queries.  Returns the Probe
    contract: active slots in lo order, keyf/key2f in qid order.
    ``span(name)`` brackets the queries (``probe.queries``), B8
    (``probe.search``) and the compaction (``probe.compact``)."""
    with span("probe.queries"):
        (keyf0, key2f0), (keyf, key2f, validf, qid) = _sorted_queries(
            rpacked, lengths, q1s, width=width, min_dinuc=min_dinuc
        )
    with span("probe.search"):
        counts, loc = sops.direct_probe(
            keyf, key2f, validf, urec, sbucket, upshift=upshift, bucket_bits=bucket_bits,
            bucket_width=bucket_width, use_k2=winops.uses_second_key(width),
        )
    with span("probe.compact"):
        return _compact_lo_order(loc, counts, qid, keyf0, key2f0)


def _probe_windows_search_impl(rpacked, lengths, q1s, ukeys, ukeys2, ukk, ustart,
                               ucount, sbucket, *, width, min_dinuc, upshift,
                               probe_steps, bucket_bits, span=_no_span):
    """Bucketed binary-search probe (port of
    ``fused._probe_windows_search_impl``): the sorted queries search the
    index's unique keys from their bucket's bounds, ``probe_steps`` rounds
    each: B9, ``sops.binary_probe``.  Same Probe contract and spans as the
    direct probe (B9 in ``probe.search``)."""
    with span("probe.queries"):
        (keyf0, key2f0), (keyf, key2f, validf, qid) = _sorted_queries(
            rpacked, lengths, q1s, width=width, min_dinuc=min_dinuc
        )
    with span("probe.search"):
        counts, loc = sops.binary_probe(
            keyf, key2f, validf, ukeys, ukeys2, ukk, ustart, ucount, sbucket,
            upshift=upshift, bucket_bits=bucket_bits, probe_steps=probe_steps,
            use_k2=winops.uses_second_key(width),
        )
    with span("probe.compact"):
        return _compact_lo_order(loc, counts, qid, keyf0, key2f0)


def probe_kind(index_aux=None, allow_pjoin: bool = True) -> str:
    """The probe ``probe_windows`` runs for these arguments: 'direct' or
    'binary' (the search probe in the aux's mode), 'sorted_join' or
    'sort_merge'."""
    if index_aux is not None:
        return index_aux.mode
    return "sorted_join" if allow_pjoin else "sort_merge"


def probe_windows(rpacked, lengths, q1s, skeys, *, width, min_dinuc,
                  index_aux=None, allow_pjoin=True, span=_no_span) -> Probe:
    """Probe stage of one batch (port of ``fused.probe_windows``).
    ``index_aux``, the index's SearchAux, selects the search probe in its
    mode (direct or binary); without it the sorted join runs, or the
    sort-merge probe when ``allow_pjoin`` is false (MUSCATO_PJOIN=0).
    Every probe returns the same Probe.  ``span(name)`` is a context that
    times the search probe's three steps, which tile it: its window
    queries and their sort (``probe.queries``), B8's or B9's launch
    (``probe.search``) and the compaction in lo order
    (``probe.compact``); the sorted join and the sort-merge probe open
    none."""
    q1s = tuple(int(q) for q in q1s)
    kind = probe_kind(index_aux, allow_pjoin)
    if kind == "direct":
        from ..engine.index import DIRECT_BUCKET_WIDTH

        aux = index_aux
        return _probe_windows_direct_impl(
            rpacked, lengths, q1s, aux.urec, aux.sbucket, width=width,
            min_dinuc=min_dinuc, upshift=aux.upshift, bucket_bits=aux.bucket_bits,
            bucket_width=DIRECT_BUCKET_WIDTH, span=span,
        )
    if kind == "binary":
        aux = index_aux
        return _probe_windows_search_impl(
            rpacked, lengths, q1s, aux.ukeys, aux.ukeys2, aux.ukk, aux.ustart,
            aux.ucount, aux.sbucket, width=width, min_dinuc=min_dinuc,
            upshift=aux.upshift, probe_steps=aux.probe_steps,
            bucket_bits=aux.bucket_bits, span=span,
        )
    impl = _probe_windows_pjoin_impl if kind == "sorted_join" else _probe_windows_impl
    return impl(rpacked, lengths, q1s, skeys, width=width, min_dinuc=min_dinuc)


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


# ---- streaming expand + verify ---------------------------------------------


class Streamed(NamedTuple):
    surv: torch.Tensor  # (surv_cap, NCOL) survivor rows in chunk order
    nsurv: torch.Tensor  # 0-d int64; above surv_cap, the rows past it were dropped
    chunks: int  # chunks of pair lanes run


def _stream_slots(counts_m, lo_m, qid_m, *, pair_chunk: int, total: int):
    """The probe slots padded for the chunk windows (oexcl with the pair
    total, lo with 0, qid with -1, pair_chunk + 1 slots each, as the JAX
    function pads them) and each chunk's first owner slot, as host ints:
    one searchsorted over every chunk base and one host copy."""
    dev = counts_m.device
    span = pair_chunk + 1
    offsets = torch.cumsum(counts_m, 0)
    oexcl = (offsets - counts_m).to(torch.int32)

    def pad(x, value):
        return torch.cat([x, torch.full((span,), value, dtype=torch.int32, device=dev)])

    bases = torch.arange(-(-total // pair_chunk), dtype=torch.int64, device=dev) * pair_chunk
    obs = torch.searchsorted(offsets, bases, right=True).clamp(max=counts_m.shape[0])
    return pad(oexcl, total), pad(lo_m, 0), pad(qid_m, -1), obs.tolist()


def _chunk_window(oexcl_p, lo_p, qid_p, ob: int, base: int, span: int):
    """Slots [ob, ob + span) rebased to the chunk that starts at pair lane
    ``base``: (oexcl - base, lo, qid), where the first slot, the only one
    that starts at or before ``base`` (the live slots precede the empty
    ones), gets oexcl 0 and its lo advanced by ``base - oexcl``.  B2 over
    these gives each chunk lane its owner's qid and postings index."""
    rel = oexcl_p[ob : ob + span] - base
    return rel.clamp(min=0), lo_p[ob : ob + span] - rel.clamp(max=0), qid_p[ob : ob + span]


def _expand_verify_impl(counts_m, lo_m, qid_m, keyf, key2f, q1s, rpacked, lengths,
                        spos, gene_start, budget, trows, gblock, *, nreads, width,
                        max_read_length, pair_chunk, surv_cap, smax, gsteps,
                        total: int, subchunk=False) -> Streamed:
    """Streaming expand + verify (port of ``fused._expand_verify_impl``):
    the ``total`` pair lanes in chunks of ``pair_chunk``.  Each chunk finds
    its lanes' owners with B2 (B6 with ``subchunk``) over its window of
    pair_chunk + 1 slots, fetches their postings with B3 (the slots are in
    lo order, so the stream is piecewise monotone), verifies each pair
    with its own window offset, and writes its survivors (r, g, s, nx,
    group1, group2, window) at ``nsurv + cumsum(keep) - 1``; rows past
    ``surv_cap`` go to a dump row and are dropped.  ``nsurv`` stays on the
    device until the caller reads it."""
    dev = counts_m.device
    nflat = keyf.shape[0]
    span = pair_chunk + 1
    oexcl_p, lo_p, qid_p, obs = _stream_slots(
        counts_m, lo_m, qid_m, pair_chunk=pair_chunk, total=total
    )
    q1t = torch.tensor(q1s, dtype=torch.int32, device=dev)
    lane = torch.arange(pair_chunk, dtype=torch.int32, device=dev)
    buf = torch.zeros((surv_cap + 1, NCOL), dtype=torch.int32, device=dev)
    nsurv = torch.zeros((), dtype=torch.int64, device=dev)
    for ci, ob in enumerate(obs):
        base = ci * pair_chunk
        qid, sidx = expand_owners(
            *_chunk_window(oexcl_p, lo_p, qid_p, ob, base, span),
            pair_cap=pair_chunk, subchunk=subchunk,
        )
        in_range = (lane < total - base) & (qid >= 0)
        site, _ = monotone_gather(spos, sidx.clamp(0, spos.shape[0] - 1))
        qpos = qid.clamp(min=0)
        k_lane = qpos // nreads
        r = torch.where(in_range, qpos - k_lane * nreads, -1)
        p = torch.where(in_range, site, -1)
        keep, nx, g, s = verify_pairs_packed(
            r, p, rpacked, lengths, gene_start, budget, q1t[k_lane.long()],
            width, max_read_length, smax, trows, gblock, gsteps,
        )
        qc = qid.clamp(0, nflat - 1).long()
        pos = nsurv + torch.cumsum(keep, 0) - 1
        buf[torch.where(keep & (pos < surv_cap), pos, surv_cap)] = torch.stack(
            [r, g, s, nx, keyf[qc], key2f[qc], k_lane], dim=1
        )
        nsurv = nsurv + keep.sum()
    return Streamed(buf[:surv_cap], nsurv, len(obs))


def expand_verify_streamed(pr: Probe, q1s, rpacked, lengths, spos, gene_start,
                           budget, *, width, max_read_length, pair_chunk,
                           surv_cap, smax, trows, gblock, gsteps, total: int,
                           subchunk=False) -> Streamed:
    """Streaming expand + verify of one batch from its probe; ``total`` is
    the probe's pair total, read by the caller.  Memory is O(pair_chunk)
    whatever the pair count, and it verifies any number of windows."""
    return _expand_verify_impl(
        pr.counts, pr.lo, pr.qid, pr.keyf, pr.key2f, tuple(q1s), rpacked,
        lengths, spos, gene_start, budget, trows, gblock,
        nreads=rpacked.shape[0], width=width, max_read_length=max_read_length,
        pair_chunk=pair_chunk, surv_cap=surv_cap, smax=smax, gsteps=gsteps,
        total=total, subchunk=subchunk,
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


def _rank_core_packed(buf, live, mm, mmtol, *, match_mode, pack_bits, span=_no_span):
    """Port of ``fused._rank_core_packed``: cap, dedup and best+MMTol with
    (r, g, s, nx) packed into 64-bit words through every sort.  Returns
    ((n, 2) int32 lo/hi rows — retained prefix in canonical (r, g, s)
    order — and the retained count).  ``span(name)`` brackets steps 1
    (``rank.cap``) and 2 (``rank.dedup``)."""
    rb, gb, sb, xb = pack_bits
    n = buf.shape[0]
    r, g, s, nx, grp, grp2, win = buf.unbind(1)
    dead = (~live).to(torch.int64)
    iota = torch.arange(n, dtype=torch.int64, device=buf.device)

    # 1. MaxMatches cap per (window, key1, key2) group; in-group order is
    #    (nx, g, s, r) for best, (g, s, r, nx) for first.
    with span("rank.cap"):
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
        seg_start = _forward_fill(newgrp, iota)
        cap = mm + (1 if match_mode == "first" else 0)
        keep = (dw < (1 << 16)) & ((iota - seg_start) < cap)

    # 2. exact dedup on (read, gene, start), canonical order; nx rides in
    #    the low bits (a function of (r, g, s)).
    with span("rank.dedup"):
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
               pack_bits=None, span=_no_span):
    """Port of ``fused._rank_core``: the unpacked rank, which the
    multi-batch path uses with full_cols (the group columns come back for
    the cross-batch re-cap).  Returns (rows, retained count).
    ``span(name)`` brackets steps 1 (``rank.cap``) and 2 (``rank.dedup``)."""
    if pack_bits is not None and not full_cols:
        return _rank_core_packed(
            buf, live, mm, mmtol, match_mode=match_mode, pack_bits=pack_bits, span=span
        )
    n = buf.shape[0]
    r, g, s, nx, grp, grp2, win = buf.unbind(1)
    dead = (~live).to(torch.int32)
    iota = torch.arange(n, dtype=torch.int64, device=buf.device)

    # 1. MaxMatches cap per (window, key1, key2) group
    #    ('first' emits MaxMatches+1 like the reference's append-then-check).
    with span("rank.cap"):
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
        seg_start = _forward_fill(newgrp, iota)
        cap = mm + (1 if match_mode == "first" else 0)
        keep = (dead_s == 0) & ((iota - seg_start) < cap)
    extras = (grp, grp2, win) if full_cols else ()

    # 2. exact dedup on (read, gene, start); establishes the final order.
    with span("rank.dedup"):
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
                   pack_bits=None, span=_no_span):
    """Device-side cap + dedup + best+MMTol over one batch's survivor
    buffer, whose first ``nsurv`` rows are live.  ``span(name)`` is a
    context that times the cap (``rank.cap``) and the dedup
    (``rank.dedup``)."""
    live = torch.arange(buf.shape[0], device=buf.device) < nsurv
    return _rank_core(buf, live, mm, mmtol, match_mode=match_mode,
                      full_cols=full_cols, pack_bits=pack_bits, span=span)


# ---- one call ------------------------------------------------------------


def match_windows(rpacked, lengths, q1s, skeys, spos, gene_start, budget, *,
                  width, min_dinuc, max_read_length, pair_chunk, surv_cap, smax,
                  trows, gblock, gsteps, index_aux=None):
    """Probe + streaming expand/verify in one call (port of
    ``fused.match_windows``, which takes ``tpacked`` where this takes the
    verify's ``trows``).  Returns (survivor rows, nsurv, pair total), the
    JAX function's result less its float total; rows past ``surv_cap`` are
    dropped, as in the streaming stage."""
    pr = probe_windows(rpacked, lengths, q1s, skeys, width=width,
                       min_dinuc=min_dinuc, index_aux=index_aux)
    total = int(pr.total)
    st = expand_verify_streamed(
        pr, q1s, rpacked, lengths, spos, gene_start, budget, width=width,
        max_read_length=max_read_length, pair_chunk=pair_chunk,
        surv_cap=surv_cap, smax=smax, trows=trows, gblock=gblock,
        gsteps=gsteps, total=total,
    )
    return st.surv, st.nsurv, total


def match_windows_dedup(rpacked, lengths, q1s, skeys, spos, gene_start, budget, *,
                        width, min_dinuc, max_read_length, pair_cap, vchunk,
                        surv_cap, smax, trows, gblock, gsteps, index_aux=None):
    """Probe + diagonal-dedup expand/verify in one call (port of
    ``fused.match_windows_dedup``, with the verify's ``trows`` in place of
    ``tpacked``).  Returns (survivor rows, nsurv, pair total), the JAX
    function's result less its float total; the first min(nsurv, surv_cap)
    rows are the survivors, those of the lowest (window, read) queries."""
    pr = probe_windows(rpacked, lengths, q1s, skeys, width=width,
                       min_dinuc=min_dinuc, index_aux=index_aux)
    ver = expand_verify_dedup(
        pr, q1s, rpacked, lengths, spos, gene_start, budget, width=width,
        max_read_length=max_read_length, pair_cap=pair_cap, vchunk=vchunk,
        smax=smax, trows=trows, gblock=gblock, gsteps=gsteps,
    )
    surv = survivor_rows(ver, pr.keyf, pr.key2f, nreads=rpacked.shape[0],
                         nwin=len(tuple(q1s)), surv_cap=surv_cap)
    return surv, ver.nsurv, pr.total
