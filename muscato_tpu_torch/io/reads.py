"""Read (fastq) ingestion, dedup, and counting — vectorized host path.

Fuses the reference's prep_reads | sort | uniqify pipeline
(/root/reference/cmd/muscato/main.go:152-221) into one host pass:

  - fastq is parsed 4 lines per record; the name is line 0 *verbatim*
    (including any leading '>' or '@') and the sequence is line 1
    (/root/reference/utils/fastq.go:36-56);
  - reads shorter than MinReadLength are skipped (length test happens on the
    original, untruncated sequence), reads are truncated at MaxReadLength,
    and non-ACGT letters become X
    (/root/reference/cmd/muscato_prep_reads/main.go:55-70);
  - names longer than 1000 chars become name[:995] + "..."
    (prep_reads main.go:74-79: maxNameLen-5 with maxNameLen=1000);
  - records are ordered like `LC_ALL=C sort` on "seq<TAB>name" lines, equal
    sequences are collapsed, and the surviving row carries the copy count
    and the ";"-joined names in that sort order; a joined name string longer
    than 1000 chars becomes joined[:996] + "..."
    (/root/reference/cmd/muscato_uniqify/main.go:89-111).

Unlike the round-1 implementation (a per-record Python loop building lists
of bytes objects), everything here is numpy over the raw file buffer:
line offsets come from one vectorized newline scan, sequence encoding is a
chunked 2-D gather through the subx lookup table, the dedup sort runs over
fixed-width void rows, and the ";"-joined names are assembled with one
vectorized ranged copy.  Python-level work is proportional to the number
of *duplicated* or *over-long* names only, so a 10M-read fastq preps in
seconds, and resident memory is the (R, MaxReadLength) code matrix plus
the name blob — never per-record Python objects.

The result is a ReadSet: a dense (R, MaxReadLength) uint8 code matrix in
read-sorted order plus lengths, copy counts, and display names — the array
analogue of reads_sorted.txt.sz.  Names are stored as one byte blob with
offsets; the `names` / `seqs` list views exist for small-scale callers and
tests and are materialized lazily.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from . import native, seqcodec, sz
from .blob import decode_rows_blob, encode_rows_matrix, gather_ranges, ranged_copy

_MAX_NAME = 1000
ENCODE_CHUNK = 1 << 20  # reads encoded per gather chunk


def _map_bytes(path: str) -> np.ndarray:
    """File bytes as a uint8 array WITHOUT holding the raw text resident:
    plain files are mmap'd (the OS pages them through cache), compressed
    files are decoded once into an unlinked disk-backed temp file and
    mmap'd from there.  At reference scale the raw fastq is the largest
    single buffer (25GB at 100M reads x 100bp); the encode/name passes
    stream through it, so paging it beats pinning it."""
    import mmap
    import tempfile

    lower = path.lower()
    if lower.endswith((".sz", ".gz")):
        data = sz.read_bytes(path)
        tmp = tempfile.TemporaryFile(
            dir=os.environ.get("MUSCATO_SPILL_DIR") or None
        )
        tmp.write(data)
        del data
        tmp.flush()
        f = tmp
    else:
        f = open(path, "rb")
    try:
        size = os.fstat(f.fileno()).st_size
        if size == 0:
            return np.zeros(0, np.uint8)
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        return np.frombuffer(mm, dtype=np.uint8)
    finally:
        f.close()  # the mapping keeps the pages alive


class ReadSet:
    """Unique reads in C-locale sort order, with copy counts and names.

    Canonical storage is numpy: codes/lengths/counts plus a name blob with
    (R+1,) offsets.  `names` and `seqs` are lazily materialized list views
    kept for small-scale callers; large-scale paths (report emission) use
    the blob directly.
    """

    def __init__(
        self,
        codes: np.ndarray,
        lengths: np.ndarray,
        counts: np.ndarray,
        names: List[bytes] | None = None,
        seqs: List[bytes] | None = None,
        num_total: int = 0,
        name_blob: np.ndarray | None = None,
        name_off: np.ndarray | None = None,
    ):
        self.codes = codes
        self.lengths = lengths
        self.counts = counts
        self.num_total = num_total
        if name_blob is not None:
            self.name_blob = name_blob
            self.name_off = name_off
            self._names = None
        else:
            names = names if names is not None else []
            self._names = list(names)
            if names:
                self.name_blob = np.frombuffer(b"".join(names), dtype=np.uint8)
                self.name_off = np.concatenate(
                    [[0], np.cumsum([len(n) for n in names], dtype=np.int64)]
                )
            else:
                self.name_blob = np.zeros(0, np.uint8)
                self.name_off = np.zeros(1, np.int64)
        self._seqs = list(seqs) if seqs is not None else None

    @property
    def names(self) -> List[bytes]:
        if self._names is None:
            blob = self.name_blob.tobytes()
            off = self.name_off
            self._names = [
                blob[off[i] : off[i + 1]] for i in range(len(off) - 1)
            ]
        return self._names

    @property
    def seqs(self) -> List[bytes]:
        if self._seqs is None:
            self._seqs = [
                seqcodec.decode(self.codes[i, : self.lengths[i]])
                for i in range(self.codes.shape[0])
            ]
        return self._seqs

    def name(self, i: int) -> bytes:
        if self._names is not None:
            return self._names[i]
        return self.name_blob[self.name_off[i] : self.name_off[i + 1]].tobytes()

    def seq(self, i: int) -> bytes:
        if self._seqs is not None:
            return self._seqs[i]
        return seqcodec.decode(self.codes[i, : self.lengths[i]])

    @property
    def num_unique(self) -> int:
        return self.codes.shape[0]


_gather_ranges = gather_ranges  # shared primitive (io.blob)


def _line_bounds(buf: np.ndarray):
    """(starts, ends) of every newline-terminated line in buf; a trailing
    chunk without '\\n' is treated as a final line (the reference's scanner
    yields it too).  Uses the native memchr scanner when available."""
    starts = native.line_offsets_native(buf)
    if starts is not None and len(buf):
        ends = np.empty(len(starts), np.int64)
        ends[:-1] = starts[1:] - 1
        ends[-1] = len(buf) - (1 if buf[-1] == 10 else 0)
        return starts, ends
    nl = np.flatnonzero(buf == 10)
    if len(buf) and (len(nl) == 0 or nl[-1] != len(buf) - 1):
        nl = np.append(nl, len(buf))
    starts = np.concatenate([[0], nl[:-1] + 1]).astype(np.int64)
    return starts, nl.astype(np.int64)


def build_readset(
    read_file: str,
    min_read_length: int,
    max_read_length: int,
) -> ReadSet:
    buf = _map_bytes(read_file)
    line_s, line_e = _line_bounds(buf)
    nrec = len(line_s) // 4
    name_s = line_s[0::4][:nrec]
    name_e = line_e[0::4][:nrec]
    seq_s = line_s[1::4][:nrec]
    seq_e = line_e[1::4][:nrec]
    return _build_from_records(
        buf, name_s, name_e, seq_s, seq_e, min_read_length, max_read_length
    )


def _empty_readset(max_read_length: int) -> ReadSet:
    return ReadSet(
        codes=np.zeros((0, max_read_length), np.uint8),
        lengths=np.zeros(0, np.int32),
        counts=np.zeros(0, np.int64),
        names=[],
        num_total=0,
    )


def _sorted_unique_records(
    buf, name_s, name_e, seq_s, seq_e, min_read_length, max_read_length
):
    """Shared core of the full and range-sharded prep paths: length-filter,
    encode, C-locale sort, and group the records.  Returns None when no
    record survives, else (srt (+1-coded sorted rows), order, starts_u,
    counts_u, group_of, lens, name_s, name_e, n)."""
    seq_len = (seq_e - seq_s).astype(np.int64)
    keep = seq_len >= min_read_length
    name_s, name_e = name_s[keep], name_e[keep]
    seq_s = seq_s[keep]
    lens = np.minimum(seq_len[keep], max_read_length).astype(np.int32)
    n = len(seq_s)
    if n == 0:
        return None

    # Host matrix width: the longest kept read, rounded up to a word (the
    # device batch path re-trims anyway; carrying MaxReadLength columns
    # for shorter reads doubled every host pass below at the default
    # MaxReadLength=2x bench read length).
    w = min(max_read_length, max(8, -(-int(lens.max()) // 8) * 8))

    # "sortable" rows: code+1 inside the read, 0 beyond — void-row order
    # then equals `LC_ALL=C sort` order of the sequences (pad sorts before
    # every base, so a prefix sorts first, exactly like the '\t' delimiter
    # in the reference's "seq\tname" lines).
    sortable = np.empty((n, w), dtype=np.uint8)
    encode_rows_matrix(
        buf, seq_s, lens, w, seqcodec._B2C + np.uint8(1), 0,
        sortable,
    )

    order = np.argsort(
        np.ascontiguousarray(sortable).view(f"V{w}").ravel(),
        kind="stable",
    )
    srt = np.empty_like(sortable)
    perm = np.ascontiguousarray(order, dtype=np.int64)
    if not native.permute_rows_native(sortable, perm, srt):
        srt = sortable[order]
    boundary = np.empty(n, dtype=bool)
    if not native.rows_differ_native(srt, boundary.view(np.uint8)):
        boundary[0] = True
        np.any(srt[1:] != srt[:-1], axis=1, out=boundary[1:])
    starts_u = np.flatnonzero(boundary)
    counts_u = np.diff(np.append(starts_u, n)).astype(np.int64)
    group_of = np.cumsum(boundary) - 1  # per sorted row

    # Within equal-sequence groups the reference's sort orders by name;
    # reorder only the duplicated rows (Python work ∝ duplicates).
    order = _order_names_within_groups(
        order, starts_u, counts_u, buf, name_s, name_e
    )
    return srt, order, starts_u, counts_u, group_of, lens, name_s, name_e, n


def _build_from_records(
    buf, name_s, name_e, seq_s, seq_e, min_read_length, max_read_length
) -> ReadSet:
    core = _sorted_unique_records(
        buf, name_s, name_e, seq_s, seq_e, min_read_length, max_read_length
    )
    if core is None:
        return _empty_readset(max_read_length)
    srt, order, starts_u, counts_u, group_of, lens, name_s, name_e, n = core

    ucodes = srt[starts_u]
    np.subtract(ucodes, 1, out=ucodes, where=ucodes > 0)
    ulens = lens[order[starts_u]]

    name_blob, name_off = _join_group_names(
        buf, name_s[order], name_e[order], group_of
    )

    return ReadSet(
        codes=ucodes,
        lengths=ulens.astype(np.int32),
        counts=counts_u,
        name_blob=name_blob,
        name_off=name_off,
        num_total=n,
    )


def _order_names_within_groups(order, starts_u, counts_u, buf, name_s, name_e):
    """Stable-reorder rows of each multi-member group by name bytes."""
    multi = np.flatnonzero(counts_u > 1)
    if len(multi) == 0:
        return order
    new_order = order.copy()
    for gi in multi:
        a = starts_u[gi]
        b = a + counts_u[gi]
        rows = order[a:b]
        keys = [buf[name_s[r] : name_e[r]].tobytes() for r in rows]
        new_order[a:b] = rows[np.argsort(np.array(keys, dtype=object), kind="stable")]
    return new_order


def _join_group_names(buf, name_s, name_e, group_of):
    """';'-join the (already group-sorted) names of each group, truncating
    names > 1000 chars to name[:995]+'...' and joined strings > 1000 chars
    to joined[:996]+'...' (prep_reads main.go:74-79, uniqify main.go:89-93).
    One vectorized ranged copy; Python work only for the rare over-long
    strings."""
    nlen = (name_e - name_s).astype(np.int64)
    # Per-name truncation (rare): handled by copying the 995-byte prefix and
    # patching "..." afterwards.
    tlen = np.minimum(nlen, _MAX_NAME)
    trunc = nlen > _MAX_NAME
    tlen[trunc] = _MAX_NAME - 5 + 3  # 995 bytes + "..."

    ngroups = int(group_of[-1]) + 1 if len(group_of) else 0
    first = np.concatenate([[True], group_of[1:] != group_of[:-1]])
    # layout: name bytes plus one ';' separator before every non-first member
    piece = tlen + (~first).astype(np.int64)
    out_end = np.cumsum(piece)
    out_start = out_end - tlen  # the name lands after its separator
    total = int(out_end[-1]) if len(out_end) else 0

    blob = np.zeros(total, np.uint8)
    blob[out_start[~first] - 1] = ord(";")
    copy_len = np.minimum(tlen, np.where(trunc, _MAX_NAME - 5, nlen))
    ranged_copy(blob, out_start, buf, name_s, copy_len)
    for i in np.flatnonzero(trunc):  # patch '...' on truncated names
        blob[out_start[i] + _MAX_NAME - 5 : out_start[i] + _MAX_NAME - 2] = np.frombuffer(
            b"...", np.uint8
        )

    goff = np.zeros(ngroups + 1, np.int64)
    goff[1:] = out_end[np.concatenate([first[1:], [True]]).nonzero()[0]]

    # Joined-name truncation per group (uniqify main.go:89-93).
    glen = np.diff(goff)
    long = np.flatnonzero(glen > _MAX_NAME)
    if len(long):
        keep_len = np.where(glen > _MAX_NAME, _MAX_NAME - 4, glen)
        new_len = np.where(glen > _MAX_NAME, _MAX_NAME - 4 + 3, glen)
        new_off = np.zeros(ngroups + 1, np.int64)
        new_off[1:] = np.cumsum(new_len)
        nblob = np.zeros(int(new_off[-1]), np.uint8)
        ranged_copy(nblob, new_off[:-1], blob, goff[:-1], keep_len)
        dots = np.frombuffer(b"...", np.uint8)
        for gi in long:
            a = new_off[gi] + _MAX_NAME - 4
            nblob[a : a + 3] = dots
        blob, goff = nblob, new_off
    return blob, goff


# ---- Range-sharded multi-host prep --------------------------------------
#
# The reference streams reads record-at-a-time in bounded memory
# (cmd/muscato_prep_reads/main.go:46-92) and merges sorted per-stage files
# (cmd/muscato/main.go:152-221 wires prep_reads | sort | uniqify).  The
# multi-host analogue here: each process parses only the records whose
# NAME LINE starts inside its byte range of the (decoded) read file, builds
# a locally-sorted unique set, and the per-host unique sets are merged into
# the global ReadSet (parallel/dist.build_readset_multihost exchanges them
# over the process collective).  Per-host prep RAM and sort time shrink
# ~process_count-fold; the merged output is byte-identical to the
# single-host build.
#
# Record ownership is positional, not content-based (the format is strict
# 4-line records and name lines are verbatim — they need not start with
# '@'): processes count the lines that start inside their byte range, one
# collective prefix-sum turns the counts into each range's global first
# line number, and records are owned by the range where their first line
# starts (their remaining 3 lines may spill into the next range — the file
# is mmap'd, so reading past the range end is free).

# Per-group byte cap on the member names a LocalReads ships: the final
# ';'-joined string is truncated at 1000 bytes, and any 996-byte merged
# prefix consumes at most ~996 bytes + one boundary member from each host,
# so members past this cumulative cap can never appear in the output.
_MEMBER_CAP = 1104


class LocalReads:
    """One process's slice of the read file, prepped and locally deduped:
    sorted unique code rows plus the per-member (pre-join) name pieces,
    name-sorted within each group and byte-capped at _MEMBER_CAP.

    Name pieces are stored post-per-name-truncation (name[:995]+'...'):
    cross-host member ordering compares these stored bytes, so two 1000+
    byte names that first differ past byte 995 tie and keep host order
    (the single-host path compares full names; the reference's own sort
    would too — the difference is unobservable in the joined output's
    retained 996 bytes unless such a pair also shares its sequence)."""

    def __init__(self, codes, lengths, counts, num_total, mem_blob, mem_off,
                 row_mem):
        self.codes = codes  # (R, w) uint8, pad 0
        self.lengths = lengths  # (R,) int32
        self.counts = counts  # (R,) int64 — full copy counts (uncapped)
        self.num_total = num_total
        self.mem_blob = mem_blob  # uint8 member-name bytes
        self.mem_off = mem_off  # (M+1,) int64 offsets into mem_blob
        self.row_mem = row_mem  # (R+1,) int64 member index per row

    @property
    def num_unique(self) -> int:
        return self.codes.shape[0]


_SCAN_CHUNK = 1 << 24  # newline scans walk the mmap in 16MB windows


def count_lines_range(buf: np.ndarray, lo: int, hi: int) -> int:
    """Number of lines STARTING in [lo, hi): line starts are byte 0 and
    every byte following a newline.  Chunked so the comparison temp never
    materializes the whole range (it would double the range's RSS)."""
    a, b = max(lo - 1, 0), max(hi - 1, 0)
    n = 0
    for p in range(a, b, _SCAN_CHUNK):
        n += int(np.count_nonzero(buf[p : min(p + _SCAN_CHUNK, b)] == 10))
    return n + (1 if lo == 0 and hi > 0 and len(buf) else 0)


def _range_line_starts(buf: np.ndarray, lo: int, hi: int) -> np.ndarray:
    a, b = max(lo - 1, 0), max(hi - 1, 0)
    parts = []
    for p in range(a, b, _SCAN_CHUNK):
        nl = np.flatnonzero(buf[p : min(p + _SCAN_CHUNK, b)] == 10)
        parts.append(nl.astype(np.int64) + p + 1)
    starts = (
        np.concatenate(parts) if parts else np.zeros(0, np.int64)
    )
    if lo == 0 and hi > 0 and len(buf):
        starts = np.concatenate([[0], starts])
    return starts


def _next_nl(buf: np.ndarray, pos: int) -> int:
    """Position of the next newline at/after pos (len(buf) if none),
    scanned in bounded chunks — never a full-tail pass."""
    ch = 1 << 16
    n = len(buf)
    while pos < n:
        win = buf[pos : min(pos + ch, n)]
        hits = np.flatnonzero(win == 10)
        if len(hits):
            return pos + int(hits[0])
        pos += ch
    return n


def _line_ends_after(buf: np.ndarray, starts: np.ndarray, need_past: int):
    """Ends of the lines starting at `starts`, plus up to `need_past`
    continuation lines past the last one (records owned by a range may
    spill their tail lines into the next range).  Returns (all_starts,
    all_ends); ends exclude the newline, a missing final newline ends at
    len(buf) (same convention as _line_bounds)."""
    ends = np.empty(len(starts), np.int64)
    if len(starts) > 1:
        ends[:-1] = starts[1:] - 1
    e = _next_nl(buf, int(starts[-1]))
    ends[-1] = e
    extra_s, extra_e = [], []
    for _ in range(need_past):
        s = e + 1
        if s >= len(buf):
            break
        e = _next_nl(buf, s)
        extra_s.append(s)
        extra_e.append(min(e, len(buf)))
        if e >= len(buf):
            break
    all_s = np.concatenate([starts, np.asarray(extra_s, np.int64)])
    all_e = np.concatenate([ends, np.asarray(extra_e, np.int64)])
    return all_s, all_e


def _empty_local() -> LocalReads:
    return LocalReads(
        codes=np.zeros((0, 8), np.uint8), lengths=np.zeros(0, np.int32),
        counts=np.zeros(0, np.int64), num_total=0,
        mem_blob=np.zeros(0, np.uint8), mem_off=np.zeros(1, np.int64),
        row_mem=np.zeros(1, np.int64),
    )


def build_readset_range(
    buf: np.ndarray,
    min_read_length: int,
    max_read_length: int,
    lo: int,
    hi: int,
    first_line: int,
) -> LocalReads:
    """Prep the records whose name line starts in byte range [lo, hi).
    `first_line` is the global line number of the range's first line (from
    the collective prefix-sum of count_lines_range over all ranges)."""
    starts = _range_line_starts(buf, lo, hi)
    # Records owned here: global line numbers ≡ 0 (mod 4).
    skip = (-first_line) % 4
    rec_starts = starts[skip::4]
    nrec = len(rec_starts)
    if nrec == 0:
        return _empty_local()
    # The last record may spill up to 3 lines past the range end.
    all_s, all_e = _line_ends_after(buf, starts, 3)
    base = skip
    name_s = all_s[base::4][:nrec]
    name_e = all_e[base::4][:nrec]
    seq_s = all_s[base + 1 :: 4][:nrec]
    seq_e = all_e[base + 1 :: 4][:nrec]
    nrec = min(len(name_s), len(seq_s))
    name_s, name_e = name_s[:nrec], name_e[:nrec]
    seq_s, seq_e = seq_s[:nrec], seq_e[:nrec]
    return _local_from_records(
        buf, name_s, name_e, seq_s, seq_e, min_read_length, max_read_length
    )


def _local_from_records(
    buf, name_s, name_e, seq_s, seq_e, min_read_length, max_read_length
) -> LocalReads:
    """Locally-deduped LocalReads from explicit record line bounds — the
    shared core of the multi-host range prep and the single-host chunked
    (bounded-memory) prep."""
    core = _sorted_unique_records(
        buf, name_s, name_e, seq_s, seq_e, min_read_length, max_read_length
    )
    if core is None:
        return _empty_local()
    srt, order, starts_u, counts_u, group_of, lens, name_s, name_e, n = core
    ucodes = srt[starts_u]
    np.subtract(ucodes, 1, out=ucodes, where=ucodes > 0)
    ulens = lens[order[starts_u]]

    # Member name pieces (group-sorted by _sorted_unique_records), byte-
    # capped per group at _MEMBER_CAP cumulative joined bytes.
    ns, ne = name_s[order], name_e[order]
    nlen = (ne - ns).astype(np.int64)
    trunc = nlen > _MAX_NAME
    tlen = np.where(trunc, _MAX_NAME - 5 + 3, nlen)
    copy_len = np.where(trunc, _MAX_NAME - 5, nlen)
    piece = tlen + 1  # + separator
    cum = np.cumsum(piece)
    first = np.concatenate([[True], group_of[1:] != group_of[:-1]])
    gbase = (cum - piece)[first][group_of]
    keep = (cum - piece - gbase) <= _MEMBER_CAP
    ns_k, cl_k, tl_k, tr_k = ns[keep], copy_len[keep], tlen[keep], trunc[keep]
    mem_off = np.zeros(len(ns_k) + 1, np.int64)
    mem_off[1:] = np.cumsum(tl_k)
    mem_blob = np.zeros(int(mem_off[-1]), np.uint8)
    ranged_copy(mem_blob, mem_off[:-1], buf, ns_k, cl_k)
    dots = np.frombuffer(b"...", np.uint8)
    for i in np.flatnonzero(tr_k):
        a = mem_off[i] + _MAX_NAME - 5
        mem_blob[a : a + 3] = dots
    # members per row (post-cap)
    row_mem = np.zeros(len(starts_u) + 1, np.int64)
    np.cumsum(np.bincount(group_of[keep], minlength=len(starts_u)),
              out=row_mem[1:])

    return LocalReads(
        codes=ucodes, lengths=ulens.astype(np.int32), counts=counts_u,
        num_total=n, mem_blob=mem_blob, mem_off=mem_off, row_mem=row_mem,
    )


def merge_local_readsets(
    parts: List["LocalReads"], max_read_length: int
) -> ReadSet:
    """Merge per-host locally-deduped LocalReads (in host order) into the
    global ReadSet — byte-identical to build_readset over the whole file.
    Counts add across hosts; member names of cross-host duplicate
    sequences are re-sorted by name bytes (stable, so equal names keep
    host = file order), then joined/truncated by the same
    _join_group_names the single-host path uses."""
    num_total = sum(p.num_total for p in parts)
    parts = [p for p in parts if p.num_unique]
    if not parts:
        return _empty_readset(max_read_length)
    w = max(p.codes.shape[1] for p in parts)

    rows_l, mem_cnt_l, mstart_l = [], [], []
    mem_base = 0
    for p in parts:
        m = np.zeros((p.num_unique, w), np.uint8)
        pw = p.codes.shape[1]
        col = np.arange(pw, dtype=np.int32)
        m[:, :pw] = np.where(
            col[None, :] < p.lengths[:, None], p.codes + np.uint8(1), 0
        )
        rows_l.append(m)
        mem_cnt_l.append(np.diff(p.row_mem))
        mstart_l.append(p.row_mem[:-1] + mem_base)
        mem_base += len(p.mem_off) - 1
    rows = np.concatenate(rows_l)
    counts = np.concatenate([p.counts for p in parts])
    lengths = np.concatenate([p.lengths for p in parts])
    mem_cnt = np.concatenate(mem_cnt_l)
    mem_start = np.concatenate(mstart_l)
    # Global member metadata (byte ranges into the concatenated blob).
    blob_cat = np.concatenate([p.mem_blob for p in parts])
    boff = np.cumsum([0] + [len(p.mem_blob) for p in parts])
    m_s = np.concatenate(
        [p.mem_off[:-1] + boff[i] for i, p in enumerate(parts)]
    )
    m_e = np.concatenate(
        [p.mem_off[1:] + boff[i] for i, p in enumerate(parts)]
    )

    n = rows.shape[0]
    order = np.argsort(
        np.ascontiguousarray(rows).view(f"V{w}").ravel(), kind="stable"
    )
    srt = rows[order]
    boundary = np.empty(n, dtype=bool)
    boundary[0] = True
    np.any(srt[1:] != srt[:-1], axis=1, out=boundary[1:])
    starts_u = np.flatnonzero(boundary)
    group_of = np.cumsum(boundary) - 1
    counts_u = np.zeros(len(starts_u), np.int64)
    np.add.at(counts_u, group_of, counts[order])

    ucodes = srt[starts_u]
    np.subtract(ucodes, 1, out=ucodes, where=ucodes > 0)
    ulens = lengths[order[starts_u]]

    # Lay members out in merged row order; cross-host groups re-sort
    # their members by the stored name bytes (Python work ∝ cross-host
    # duplicate sequences only).
    mc = mem_cnt[order]
    midx = gather_ranges(mem_start[order], mc)
    gm_s, gm_e = m_s[midx], m_e[midx]
    mrow = np.repeat(group_of, mc)
    multi = np.flatnonzero(np.diff(np.append(starts_u, n)) > 1)
    if len(multi):
        row_m_off = np.zeros(len(starts_u) + 1, np.int64)
        np.cumsum(np.bincount(mrow, minlength=len(starts_u)),
                  out=row_m_off[1:])
        for gi in multi:
            a, b = row_m_off[gi], row_m_off[gi + 1]
            keys = [
                blob_cat[gm_s[j] : gm_e[j]].tobytes() for j in range(a, b)
            ]
            sub = np.argsort(np.array(keys, dtype=object), kind="stable")
            gm_s[a:b] = gm_s[a:b][sub]
            gm_e[a:b] = gm_e[a:b][sub]
    name_blob, name_off = _join_group_names(blob_cat, gm_s, gm_e, mrow)

    return ReadSet(
        codes=ucodes, lengths=ulens.astype(np.int32), counts=counts_u,
        name_blob=name_blob, name_off=name_off, num_total=num_total,
    )


# ---- Bounded-memory single-host prep -------------------------------------
#
# The reference never materializes the read collection: prep_reads streams
# record-at-a-time and GNU `sort -S 50%` spills sorted runs to disk
# (/root/reference/cmd/muscato_prep_reads/main.go:46-92,
# cmd/muscato/main.go:181-189), so "hundreds of millions of reads" need
# not fit in RAM.  The vectorized build_readset above is much faster but
# holds the full unique matrix + name blob resident (27GB peak at 10M
# reads, BENCHMARKS.md).  This is the same-spirit spill story: scan the
# fastq sequentially in chunks of `chunk_reads` records, locally
# sort/dedup each chunk with the SAME core as the multi-host range prep
# (LocalReads runs spilled to disk as .npy), then stream a k-way merge of
# the sorted unique runs into memmap-backed output files.  Peak RSS is
# O(chunk + nruns * merge block); the resulting ReadSet is byte-identical
# to build_readset (same fuzz harness as the range-sharded prep) with
# codes/counts/names backed by disk memmaps the engine streams from.

# Per-iteration merge budget: the boundary pull takes up to one block
# from EVERY run, so the per-run block must shrink as runs multiply or
# the merge materializes nruns x block rows at once (measured: chunk=250k
# over 10M reads pulled ~the whole input per iteration).  _MERGE_BLOCK
# bounds the total pulled rows per iteration; _merge_block_rows splits it.
_MERGE_BLOCK = 1 << 20


def _merge_block_rows(nruns: int) -> int:
    return max(1 << 12, _MERGE_BLOCK // max(nruns, 1))


def _scan_records(buf: np.ndarray, pos: int, nrec: int):
    """Line bounds of the next `nrec` 4-line records starting at byte
    `pos` (a line start).  Returns (name_s, name_e, seq_s, seq_e,
    next_pos); scans newlines in bounded windows — never a whole-file
    pass, so peak RSS tracks the chunk, not the file."""
    need = 4 * nrec + 1  # one extra start = first line of the NEXT chunk
    starts = [np.asarray([pos], np.int64)] if pos < len(buf) else []
    got = 1 if pos < len(buf) else 0
    p = pos
    while got < need and p < len(buf):
        win = buf[p : min(p + _SCAN_CHUNK, len(buf))]
        nl = np.flatnonzero(win == 10).astype(np.int64) + p + 1
        p += len(win)
        nl = nl[nl < len(buf)]
        starts.append(nl)
        got += len(nl)
    s = np.concatenate(starts) if starts else np.zeros(0, np.int64)
    s = s[:need]
    nlines = min(len(s), 4 * nrec)
    nrec = nlines // 4
    next_pos = int(s[4 * nrec]) if len(s) > 4 * nrec else len(buf)
    # A trailing partial record (1-3 lines) belongs to no chunk — the
    # 4-line parser in build_readset drops it too (nrec = lines // 4).
    if next_pos == len(buf) and nlines % 4:
        pass  # dropped, matching the full parser
    ends = np.empty(nlines, np.int64)
    if nlines:
        if len(s) > nlines:
            ends[:] = s[1 : nlines + 1] - 1
        else:
            ends[:-1] = s[1:nlines] - 1
            e = _next_nl(buf, int(s[nlines - 1]))
            ends[-1] = min(e, len(buf))
    name_s, name_e = s[0 : 4 * nrec : 4], ends[0 : 4 * nrec : 4]
    seq_s, seq_e = s[1 : 4 * nrec : 4], ends[1 : 4 * nrec : 4]
    return name_s, name_e, seq_s, seq_e, next_pos


class _RunWriter:
    """Spill directory of sorted unique runs (one LocalReads per chunk)."""

    def __init__(self, spill_dir: str):
        self.dir = spill_dir
        os.makedirs(spill_dir, exist_ok=True)
        self.n = 0
        self.num_total = 0
        self.width = 8

    def add(self, lr: LocalReads) -> None:
        self.num_total += lr.num_total
        if not lr.num_unique:
            return
        d = os.path.join(self.dir, f"run{self.n:05d}")
        os.makedirs(d, exist_ok=True)
        for name in ("codes", "lengths", "counts", "mem_blob", "mem_off",
                     "row_mem"):
            np.save(os.path.join(d, f"{name}.npy"), getattr(lr, name))
        self.width = max(self.width, lr.codes.shape[1])
        self.n += 1


class _RunReader:
    """Cursor over one spilled run; serves +1-coded rows padded to the
    global width in bounded blocks (memmap-backed, nothing resident)."""

    def __init__(self, d: str, width: int, block_rows: int = _MERGE_BLOCK):
        self.block_rows = block_rows
        self.codes = np.load(os.path.join(d, "codes.npy"), mmap_mode="r")
        self.lengths = np.load(os.path.join(d, "lengths.npy"), mmap_mode="r")
        self.counts = np.load(os.path.join(d, "counts.npy"), mmap_mode="r")
        self.mem_blob = np.load(os.path.join(d, "mem_blob.npy"), mmap_mode="r")
        self.mem_off = np.load(os.path.join(d, "mem_off.npy"), mmap_mode="r")
        self.row_mem = np.load(os.path.join(d, "row_mem.npy"), mmap_mode="r")
        self.w = width
        self.pos = 0
        self.nrows = self.codes.shape[0]
        self._blk = None  # (start, +1-coded rows)

    def exhausted(self) -> bool:
        return self.pos >= self.nrows

    def block(self) -> np.ndarray:
        """+1-coded rows [pos, pos+block_rows) padded to global width."""
        if self._blk is not None and self._blk[0] == self.pos:
            return self._blk[1]
        hi = min(self.pos + self.block_rows, self.nrows)
        c = np.asarray(self.codes[self.pos : hi])
        ln = np.asarray(self.lengths[self.pos : hi])
        m = np.zeros((hi - self.pos, self.w), np.uint8)
        col = np.arange(c.shape[1], dtype=np.int32)
        m[:, : c.shape[1]] = np.where(col[None, :] < ln[:, None], c + np.uint8(1), 0)
        self._blk = (self.pos, m)
        return m


def build_readset_chunked(
    read_file: str,
    min_read_length: int,
    max_read_length: int,
    chunk_reads: int,
    spill_dir: str | None = None,
) -> ReadSet:
    """Bounded-memory build_readset: byte-identical output, peak RSS
    O(chunk_reads) + O(nruns * merge block) instead of O(total reads).
    The returned ReadSet's codes/lengths/counts/name arrays are disk
    memmaps (unlinked temp files unless spill_dir is given), so resident
    memory stays bounded through matching too — the engine batches copy
    row ranges out of the memmap."""
    import tempfile

    assert chunk_reads > 0
    buf = _map_bytes(read_file)
    if not len(buf):
        return _empty_readset(max_read_length)
    own_spill = spill_dir is None
    spill_dir = spill_dir or tempfile.mkdtemp(
        prefix="muscato_prep_", dir=os.environ.get("MUSCATO_SPILL_DIR") or None
    )
    runs = _RunWriter(spill_dir)
    pos = 0
    while pos < len(buf):
        name_s, name_e, seq_s, seq_e, pos = _scan_records(buf, pos, chunk_reads)
        if not len(name_s):
            break
        runs.add(_local_from_records(
            buf, name_s, name_e, seq_s, seq_e,
            min_read_length, max_read_length,
        ))
    try:
        if runs.n == 0:
            rs = _empty_readset(max_read_length)
            rs.num_total = runs.num_total
            return rs
        return _merge_runs_streaming(runs, max_read_length)
    finally:
        if own_spill:
            import shutil

            shutil.rmtree(spill_dir, ignore_errors=True)


def _merge_runs_streaming(runs: _RunWriter, max_read_length: int) -> ReadSet:
    """K-way streaming merge of sorted unique runs into memmap-backed
    output.  Per iteration every run contributes its rows <= the global
    safe boundary (the smallest last-loaded row across live runs — the
    run that defines it advances a full block, so progress is linear);
    pulled rows are merged exactly like merge_local_readsets, then the
    finished output block is appended to disk.  No row of a given
    sequence can remain unpulled once any equal row is pulled (both are
    <= the boundary), so groups never span output blocks."""
    import tempfile

    w = runs.width
    block_rows = _merge_block_rows(runs.n)
    readers = [
        _RunReader(os.path.join(runs.dir, f"run{i:05d}"), w, block_rows)
        for i in range(runs.n)
    ]
    tdir = os.environ.get("MUSCATO_SPILL_DIR") or None
    files = {
        name: tempfile.TemporaryFile(dir=tdir)
        for name in ("codes", "lengths", "counts", "name_blob", "name_off")
    }
    out_rows = 0
    name_base = 0
    files["name_off"].write(np.zeros(1, np.int64).tobytes())

    live = [r for r in readers if not r.exhausted()]
    while live:
        # Safe boundary: the smallest per-run last-loaded row.
        last = [r.block()[-1].tobytes() for r in live]
        boundary = min(last)
        pulled_rows, pulled_cnt, pulled_len = [], [], []
        pulled_ms, pulled_me, pulled_mc, blobs = [], [], [], []
        blob_base = 0
        for r in live:
            blk = r.block()
            k = int(np.searchsorted(
                np.ascontiguousarray(blk).view(f"V{w}").ravel(),
                np.frombuffer(boundary, dtype=f"V{w}")[0], side="right",
            ))
            if k == 0:
                continue
            sl = slice(r.pos, r.pos + k)
            pulled_rows.append(blk[:k])
            pulled_cnt.append(np.asarray(r.counts[sl]))
            pulled_len.append(np.asarray(r.lengths[sl]))
            m0, m1 = int(r.row_mem[r.pos]), int(r.row_mem[r.pos + k])
            pulled_mc.append(np.asarray(np.diff(r.row_mem[sl.start : sl.stop + 1])))
            moff = np.asarray(r.mem_off[m0 : m1 + 1], np.int64)
            b0 = int(moff[0])
            blobs.append(np.asarray(r.mem_blob[b0 : int(moff[-1])]))
            pulled_ms.append(moff[:-1] - b0 + blob_base)
            pulled_me.append(moff[1:] - b0 + blob_base)
            blob_base += int(moff[-1]) - b0
            r.pos += k
            r._blk = None
        live = [r for r in live if not r.exhausted()]
        if not pulled_rows:
            continue
        rows = np.concatenate(pulled_rows)
        counts = np.concatenate(pulled_cnt)
        lengths = np.concatenate(pulled_len)
        mem_cnt = np.concatenate(pulled_mc)
        blob_cat = np.concatenate(blobs) if blobs else np.zeros(0, np.uint8)
        m_s = np.concatenate(pulled_ms)
        m_e = np.concatenate(pulled_me)

        n = rows.shape[0]
        order = np.argsort(
            np.ascontiguousarray(rows).view(f"V{w}").ravel(), kind="stable"
        )
        srt = rows[order]
        boundary_b = np.empty(n, dtype=bool)
        boundary_b[0] = True
        np.any(srt[1:] != srt[:-1], axis=1, out=boundary_b[1:])
        starts_u = np.flatnonzero(boundary_b)
        group_of = np.cumsum(boundary_b) - 1
        counts_u = np.zeros(len(starts_u), np.int64)
        np.add.at(counts_u, group_of, counts[order])
        ucodes = srt[starts_u].copy()
        np.subtract(ucodes, 1, out=ucodes, where=ucodes > 0)
        ulens = lengths[order[starts_u]]

        # Member layout in merged order; cross-run groups re-sort their
        # members by stored name bytes (work ∝ cross-run duplicates) —
        # identical policy to merge_local_readsets.
        row_moff = np.zeros(n + 1, np.int64)
        row_moff[1:] = np.cumsum(mem_cnt)
        mc = mem_cnt[order]
        midx = gather_ranges(row_moff[:-1][order], mc)
        gm_s, gm_e = m_s[midx], m_e[midx]
        mrow = np.repeat(group_of, mc)
        multi = np.flatnonzero(np.diff(np.append(starts_u, n)) > 1)
        if len(multi):
            grp_moff = np.zeros(len(starts_u) + 1, np.int64)
            np.cumsum(np.bincount(mrow, minlength=len(starts_u)),
                      out=grp_moff[1:])
            for gi in multi:
                a, b = grp_moff[gi], grp_moff[gi + 1]
                keys = [
                    blob_cat[gm_s[j] : gm_e[j]].tobytes()
                    for j in range(a, b)
                ]
                sub = np.argsort(np.array(keys, dtype=object), kind="stable")
                gm_s[a:b] = gm_s[a:b][sub]
                gm_e[a:b] = gm_e[a:b][sub]
        nb, noff = _join_group_names(blob_cat, gm_s, gm_e, mrow)

        files["codes"].write(np.ascontiguousarray(ucodes).tobytes())
        files["lengths"].write(ulens.astype(np.int32).tobytes())
        files["counts"].write(counts_u.tobytes())
        files["name_blob"].write(np.ascontiguousarray(nb).tobytes())
        files["name_off"].write((noff[1:] + name_base).tobytes())
        name_base += int(noff[-1])
        out_rows += len(starts_u)

    def _mm(f, dtype, shape):
        f.flush()
        size = int(np.prod(shape))
        if size == 0:
            return np.zeros(shape, dtype)
        return np.memmap(f, dtype=dtype, mode="r", shape=shape)

    rs = ReadSet(
        codes=_mm(files["codes"], np.uint8, (out_rows, w)),
        lengths=_mm(files["lengths"], np.int32, (out_rows,)),
        counts=_mm(files["counts"], np.int64, (out_rows,)),
        name_blob=_mm(
            files["name_blob"], np.uint8,
            (files["name_blob"].tell(),),
        ),
        name_off=_mm(files["name_off"], np.int64, (out_rows + 1,)),
        num_total=runs.num_total,
    )
    rs._spill_files = files  # keep the unlinked temp files alive
    return rs


def write_reads_sorted(rs: ReadSet, path: str,
                       rows_per_slice: int = 4_000_000) -> None:
    """Persist the reads_sorted.txt.sz equivalent (seq \\t count \\t names),
    assembled with vectorized ranged copies (no per-read Python loop).

    Streams `rows_per_slice` rows at a time through sz.StreamWriter —
    the one-shot blob at 100M reads was ~12GB plus tobytes/S20 copies
    (the measured ~50GB anon-RSS spike of the round-5 100M run); the
    sliced emission is byte-identical and O(slice) memory."""
    n = rs.num_unique
    if n == 0:
        sz.write_bytes(path, b"")
        return
    with sz.StreamWriter(path) as w:
        for lo in range(0, n, rows_per_slice):
            hi = min(lo + rows_per_slice, n)
            m = hi - lo
            counts_b = rs.counts[lo:hi].astype("S20")
            clen = np.char.str_len(counts_b).astype(np.int64)
            slen = rs.lengths[lo:hi].astype(np.int64)
            nlen = np.diff(rs.name_off[lo:hi + 1])
            row_len = slen + 1 + clen + 1 + nlen + 1
            out_end = np.cumsum(row_len)
            out_start = out_end - row_len
            blob = np.zeros(int(out_end[-1]), np.uint8)

            # sequence bytes (decode codes straight into the output blob)
            decode_rows_blob(
                blob, out_start, rs.codes, rs.codes.shape[1],
                np.arange(lo, hi, dtype=np.int64), slen, seqcodec._C2B,
            )
            blob[out_start + slen] = ord("\t")
            # counts (fixed-width S20 buffer, actual decimal length clen)
            cbuf = np.frombuffer(counts_b.tobytes(), np.uint8)
            ranged_copy(blob, out_start + slen + 1, cbuf,
                        np.arange(m, dtype=np.int64) * 20, clen)
            blob[out_start + slen + 1 + clen] = ord("\t")
            # names
            ranged_copy(blob, out_start + slen + 2 + clen,
                        rs.name_blob, rs.name_off[lo:hi], nlen)
            blob[out_end - 1] = ord("\n")
            w.write(blob)
