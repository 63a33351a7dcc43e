"""Target index on the device (port of ``muscato_tpu/engine/index.py``).

The targets are compiled once into the sorted window-key index that read
batches probe: the window key of every valid window position, sorted as
uint32 (ties by position), with the positions alongside.  A window
position p is valid iff the whole window lies inside one gene:

  tpacked    (S/8+pad,) int32  nibble-packed gene stream (uint32 bit patterns)
  gene_start (G+1,) int32      gene offsets into the stream
  skeys      (V,)  int32       sorted window keys (uint32 bit patterns)
  skeys2     (V,)  int32       the second hash word, on a device build
                               unless keep_k2=False
  spos       (V,)  int32       the window positions, aligned with skeys

Two builds give the same arrays.  The default host build computes keys
and sort on the host (in C when the native library is present) and
uploads the sorted arrays; it keeps the host copies of (key1, key2,
position), and the second hash word never goes to the device: the probe
joins on key1 alone, and key1 collisions between distinct wide k-mers die
in the byte-true verify.  ``device_build=True`` uploads the gene stream
and computes the keys, the validity and the sort on the device
(``_sorted_windows``, in bounded chunks and sort groups), as the JAX
mesh builds every shard, and packs the stream there too; it keeps no host copy, so ``save`` and
``search_aux`` read the arrays back.

``TargetIndex.save`` writes the JAX package's index file, which
``TargetIndex.load`` reads back instead of building; each package reads
the other's.  The search probe, which the engine takes when the index is
much larger than a read batch's queries, reads a unique-key view of the
same arrays (``SearchAux``), built once per index with torch ops on the
index's device (``build_search_aux_device``; the numpy
``build_search_aux`` is its plain reference).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..io.targets import TargetSet

from ..ops import packed as pops
from ..ops import search as sops
from ..ops import windows as winops

INVALID_KEY = np.uint32(0xFFFFFFFF)

INDEX_FORMAT_VERSION = 2

DIRECT_BUCKET_WIDTH = 16  # max records fetched per direct probe
MAX_DIRECT_BITS = 26  # 268MB bucket-table cap


@dataclass
class SearchAux:
    """Unique-key view + bucket table for the search probe (device tensors
    are int32 bit patterns of the JAX package's uint32 arrays).

    Duplicate-key runs collapse to one entry, so bucket depth tracks
    distinct keys.  Two probe modes:

    mode='direct': the bucket table is sized so that no bucket holds more
    than DIRECT_BUCKET_WIDTH distinct keys (hash-uniform keys, which wide
    windows give, always qualify).  A probe fetches its bucket's bounds and
    then the bucket's 16-byte (k1, k2, start, count) records in ``urec``:
    no search loop.

    mode='binary': the fallback for skewed keys, a bounded search within
    the bucket over the interleaved key pairs ``ukk``, then the hit's run
    start and length.  ``ukeys`` and ``ukeys2`` are the two columns of
    ``ukk`` and ``ustart`` and ``ucount`` the two columns of one (U, 2)
    tensor of (start, count) pairs, so that B9 reads a hit's start and
    count in one 8-byte load: 16 bytes a unique key in all.
    """

    mode: str
    sbucket: torch.Tensor  # (2**bucket_bits+1,) int32 per-bucket bounds
    bucket_bits: int
    upshift: int
    # direct mode
    urec: torch.Tensor | None = None  # (U*4 + pad,) [k1, k2, start, count]
    # binary mode
    ukeys: torch.Tensor | None = None  # (U,) key1, ukk's even words
    ukeys2: torch.Tensor | None = None  # (U,) key2, ukk's odd words
    ustart: torch.Tensor | None = None  # (U,) run start in spos, stride 2
    ucount: torch.Tensor | None = None  # (U,) run length, beside its start
    ukk: torch.Tensor | None = None  # (2U,) interleaved [k1, k2]
    probe_steps: int = 0
    build_s: float = 0.0  # build seconds, on the index's device

    @property
    def nbytes(self) -> int:
        """Device bytes of the aux's tensors, each storage counted once
        (the binary mode's columns share two)."""
        storages = {}
        for t in (self.sbucket, self.urec, self.ukeys, self.ukeys2, self.ustart,
                  self.ucount, self.ukk):
            if t is not None:
                st = t.untyped_storage()
                storages[st.data_ptr()] = st.nbytes()
        return sum(storages.values())


@dataclass
class TargetIndex:
    tpacked: torch.Tensor
    gene_start: torch.Tensor  # (G+1,) int32 on the device
    gene_start_np: np.ndarray  # the same, on the host
    skeys: torch.Tensor
    spos: torch.Tensor
    width: int
    num_valid: int
    num_bases: int
    # The device build's second key word (the host build keeps it in
    # host_arrays alone).
    skeys2: torch.Tensor | None = field(default=None, repr=False)
    # Host copies of the sorted (skeys, skeys2, spos) that save() writes;
    # None on a device build.
    host_arrays: tuple | None = field(default=None, repr=False)
    build_timings: dict | None = field(default=None, repr=False)
    _aux: SearchAux | None = field(default=None, repr=False)
    _trows: tuple | None = field(default=None, repr=False)
    _gblock: tuple | None = field(default=None, repr=False)

    @property
    def device(self) -> torch.device:
        return self.skeys.device

    def trows(self, nwords: int) -> torch.Tensor:
        """Overlapping row view of tpacked for the verify's row gather;
        built once per read word count (~2.75x tpacked's bytes)."""
        if self._trows is None or self._trows[0] != nwords:
            t = pops.build_trows(self.tpacked, nwords, self.num_bases)
            self._trows = (nwords, t)
        return self._trows[1]

    def gene_block(self) -> tuple:
        """(gblock device tensor, refine steps) for the gene lookup."""
        if self._gblock is None:
            gb, steps = pops.build_gene_block(self.gene_start_np, self.num_bases)
            self._gblock = (torch.from_numpy(gb).to(self.device), steps)
        return self._gblock

    def _sorted_host(self) -> tuple:
        """The sorted (key1, key2, position) as host uint32, uint32 and
        int32 arrays: the host build's copies, or a device build's arrays
        read back."""
        if self.host_arrays is not None:
            return self.host_arrays
        if self.skeys2 is None:
            raise ValueError("a device build without keep_k2 (a mesh shard) keeps no "
                             "second key word to write or search")
        return tuple(t.cpu().numpy().view(dt) for t, dt in (
            (self.skeys, np.uint32), (self.skeys2, np.uint32), (self.spos, np.int32)))

    def search_aux(self) -> SearchAux:
        """Build (once) the unique-key + bucket view for the search probe,
        with torch ops on the index's device (``build_search_aux_device``)
        from the sorted keys there.  A host build keeps its second key
        word in ``host_arrays`` alone: it is uploaded for the build only."""
        if self._aux is None:
            t0 = time.perf_counter()
            if self.skeys2 is not None:
                k2 = self.skeys2
            elif self.host_arrays is not None:
                k2 = _upload(self.host_arrays[1], self.device)
            else:
                raise ValueError("a device build without keep_k2 (a mesh shard) keeps no "
                                 "second key word to search")
            self._aux = build_search_aux_device(self.skeys, k2, self.width)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._aux.build_s = time.perf_counter() - t0
        return self._aux

    def save(self, path: str) -> None:
        """Write the sorted key arrays (npz: version, width, num_valid,
        num_bases, skeys, skeys2, spos), so that later runs skip the build
        sort; tpacked and gene_start are recomputed from the TargetSet."""
        k1, k2, sp = self._sorted_host()
        np.savez(
            path,
            version=np.int64(INDEX_FORMAT_VERSION),
            width=np.int64(self.width),
            num_valid=np.int64(self.num_valid),
            num_bases=np.int64(self.num_bases),
            skeys=k1, skeys2=k2, spos=sp,
        )

    @classmethod
    def load(cls, path: str, ts: TargetSet, width: int, device) -> "TargetIndex":
        """An index file written by ``save`` (or by the JAX package) for
        the TargetSet ``ts`` at ``width``, on ``device``; raises ValueError
        for another format version, width or base count."""
        device = torch.device(device)
        d = np.load(path)
        if int(d["version"]) != INDEX_FORMAT_VERSION:
            raise ValueError(f"index file {path}: unsupported version {int(d['version'])}")
        if int(d["width"]) != width or int(d["num_bases"]) != int(ts.gene_start[-1]):
            raise ValueError(
                f"index file {path} was built for a different width/target set"
            )
        k1, k2, sp = d["skeys"], d["skeys2"], d["spos"]
        gene_start_np = np.asarray(ts.gene_start, dtype=np.int64).astype(np.int32)
        return cls(
            tpacked=_upload(pops.pack_stream(np.asarray(ts.tcat)), device),
            gene_start=_upload(gene_start_np, device), gene_start_np=gene_start_np,
            skeys=_upload(k1, device), spos=_upload(sp, device), width=width,
            num_valid=int(d["num_valid"]), num_bases=int(d["num_bases"]),
            host_arrays=(k1, k2, sp),
        )


def build_search_aux(uk1, uk2, starts, counts, width: int, device) -> SearchAux:
    """Pick the search-probe layout for a unique-key table and upload it:
    the host build, the plain reference that ``build_search_aux_device``
    equals array for array.

    Prefers 'direct': the smallest bucket table whose largest bucket holds
    at most DIRECT_BUCKET_WIDTH distinct keys; skewed distributions fall
    back to the bounded binary search."""
    device = torch.device(device)
    u = len(uk1)
    upshift = sops.bucket_shift(width)
    # The key's top 32-bit image; its bucket at `bits` is its top `bits` bits.
    top32 = ((uk1.astype(np.uint64) << np.uint64(upshift)) & np.uint64(0xFFFFFFFF)).astype(
        np.uint32
    )
    for bits in range(_direct_start_bits(u), MAX_DIRECT_BITS + 1):
        b = (top32 >> np.uint32(32 - bits)).astype(np.int64)
        per = np.bincount(b, minlength=1 << bits)
        if int(per.max(initial=0)) <= DIRECT_BUCKET_WIDTH:
            bucket = np.zeros((1 << bits) + 1, np.int32)
            np.cumsum(per, out=bucket[1:])
            rec = np.empty((u + DIRECT_BUCKET_WIDTH, 4), np.uint32)
            rec[:u, 0] = uk1
            rec[:u, 1] = uk2
            rec[:u, 2] = starts.astype(np.uint32)
            rec[:u, 3] = counts.astype(np.uint32)
            # Padding records: never equal to a live query's key1 + key2.
            rec[u:] = (0xFFFFFFFF, 0xFFFFFFFF, 0, 0)
            return SearchAux(
                mode="direct", sbucket=_upload(bucket, device), bucket_bits=bits,
                upshift=upshift, urec=_upload(rec.reshape(-1), device),
            )
    bucket, probe_steps, bucket_bits = sops.build_buckets_host(uk1, upshift)
    ukk = _upload(np.stack([uk1, uk2], axis=1), device)
    usc = _upload(np.stack([starts.astype(np.int32), counts.astype(np.int32)], axis=1), device)
    return SearchAux(
        mode="binary", sbucket=_upload(bucket, device), bucket_bits=bucket_bits,
        upshift=upshift, ukeys=ukk[:, 0], ukeys2=ukk[:, 1], ustart=usc[:, 0],
        ucount=usc[:, 1], ukk=ukk.view(-1), probe_steps=probe_steps,
    )


def _direct_start_bits(u: int) -> int:
    """The first bucket width the direct layout tries for u unique keys."""
    return max(16, int(np.ceil(np.log2(max(u, 1) / 4 + 1))))


def _bucket_ids(uk1: torch.Tensor, upshift: int, bits: int) -> torch.Tensor:
    """The bucket of each key at ``bits`` (``sops.bucket_of``: the top
    ``bits`` of the uint32 ``key << upshift``, bits shifted past 32 lost),
    sorted, as int32: computed in int32 in place (``<<`` on int32 wraps as
    on uint32), with no int64 copy of the keys.  Keys of the width's range
    keep their order under the shift; any others are sorted here (the
    per-bucket counts are the same)."""
    b = uk1 << upshift
    b >>= 32 - bits
    b &= (1 << bits) - 1
    if b.numel() > 1 and bool((b[1:] < b[:-1]).any()):
        b = torch.sort(b).values
    return b


def _binary_bucket_table(uk1: torch.Tensor, upshift: int, bits: int) -> torch.Tensor:
    """``sops.build_buckets_host``'s table of the sorted keys ``uk1``:
    bucket[j] counts the keys whose unshifted-width scaled key
    ``(key << upshift) >> (32 - bits)`` (no 32-bit mask) is below j, that
    is the keys below j's least key, ceil(j * 2**(32 - bits - upshift)).
    The keys are sorted as uint32, so one searchsorted of the 2**bits + 1
    least keys into the keys with the sign bit flipped gives the table."""
    dev = uk1.device
    j = torch.arange((1 << bits) + 1, dtype=torch.int64, device=dev)
    r = 32 - bits - upshift
    least = j << r if r >= 0 else (j + (1 << -r) - 1) >> -r
    bound = (least.clamp(max=pops.M32) - (1 << 31)).to(torch.int32)
    table = torch.searchsorted(uk1 ^ -(1 << 31), bound, out_int32=True)
    table[least > pops.M32] = uk1.numel()
    return table


def _runs_in_place(buf: torch.Tensor, u: int, n: int) -> torch.Tensor:
    """(u, 2) [start, count] pairs of the u runs of n sorted windows, made in
    place in ``buf`` (2u int32, the runs' starts in its first half): the
    starts move to the even words in blocks [ceil(a / 2), a) from the top,
    each landing on [a, 2a), words already moved or free, so that no block
    overlaps its source; then each count is the next start less its own."""
    pairs = buf.view(u, 2)
    a = u
    while a > 1:
        lo = (a + 1) // 2
        pairs[lo:a, 0] = buf[lo:a]
        a = lo
    if u:
        pairs[:-1, 1] = pairs[1:, 0]
        pairs[-1, 1] = n
        pairs[:, 1] -= pairs[:, 0]
    return pairs


def build_search_aux_device(k1: torch.Tensor, k2: torch.Tensor, width: int) -> SearchAux:
    """``build_search_aux`` of the sorted (V,) key words ``k1`` and ``k2``
    (int32 bit patterns), computed with torch ops on their device: the runs
    of equal (k1, k2), their starts and counts, then the direct layout or
    the binary one, array for array as the host build gives them.  The
    bucket ids of the sorted unique keys are sorted, so a bucket width fits
    iff no id equals the one DIRECT_BUCKET_WIDTH places on, and the bucket
    table is a searchsorted of the bucket boundaries: no bincount of each
    width.

    The starts and the unique key1 share one buffer of 8 bytes a unique
    key.  Peak memory, for u unique keys, beside k1 and k2: the direct
    layout 24 bytes a key (its 16-byte records and the buffer, through
    whose second half key2 and the counts pass; before them the int32
    bucket ids of the width search); the binary layout 16, what it keeps:
    ukk is filled from the buffer's second half (key1, then key2 gathered
    there), and the buffer then becomes the (start, count) pairs in place
    (``_runs_in_place``)."""
    dev = k1.device
    n = k1.numel()
    new_run = torch.ones(n, dtype=torch.bool, device=dev)
    if n > 1:
        torch.ne(k1[1:], k1[:-1], out=new_run[1:])
        new_run[1:] |= k2[1:] != k2[:-1]
    first = torch.nonzero(new_run).squeeze(1)
    del new_run
    u = first.numel()
    buf = torch.empty(2 * u, dtype=torch.int32, device=dev)
    starts, uk1 = buf[:u], buf[u:]
    starts.copy_(first)
    del first
    torch.index_select(k1, 0, starts, out=uk1)
    upshift = sops.bucket_shift(width)
    w = DIRECT_BUCKET_WIDTH
    for bits in range(_direct_start_bits(u), MAX_DIRECT_BITS + 1):
        b = _bucket_ids(uk1, upshift, bits)
        fits = u <= w or not bool((b[w:] == b[:-w]).any())
        if fits:
            bucket = torch.searchsorted(
                b, torch.arange((1 << bits) + 1, dtype=torch.int32, device=dev),
                out_int32=True)
        del b
        if not fits:
            continue
        rec = torch.empty((u + w, 4), dtype=torch.int32, device=dev)
        # Key2, then the counts, pass through the buffer's second half.
        rec[:u, 0] = uk1
        torch.index_select(k2, 0, starts, out=uk1)
        rec[:u, 1] = uk1
        torch.sub(starts[1:], starts[:-1], out=uk1[:-1])
        uk1[-1:] = n - starts[-1:]
        rec[:u, 3] = uk1
        rec[:u, 2] = starts
        del starts, uk1, buf
        # Padding records: never equal to a live query's key1 + key2.
        rec[u:, :2] = -1
        rec[u:, 2:] = 0
        return SearchAux(mode="direct", sbucket=bucket, bucket_bits=bits,
                         upshift=upshift, urec=rec.view(-1))
    bits = sops.bucket_bits_for(u)
    bucket = _binary_bucket_table(uk1, upshift, bits)
    max_run = int(torch.diff(bucket).max()) if u else 1
    ukk = torch.empty((u, 2), dtype=torch.int32, device=dev)
    ukk[:, 0] = uk1
    torch.index_select(k2, 0, starts, out=uk1)
    ukk[:, 1] = uk1
    del starts, uk1
    usc = _runs_in_place(buf, u, n)
    return SearchAux(
        mode="binary", sbucket=bucket, bucket_bits=bits, upshift=upshift,
        ukeys=ukk[:, 0], ukeys2=ukk[:, 1], ustart=usc[:, 0], ucount=usc[:, 1],
        ukk=ukk.view(-1), probe_steps=max(1, max_run.bit_length()),
    )


def _boundary_cumsum_np(gene_start: np.ndarray, s: int) -> np.ndarray:
    """cum[x] = number of interior gene boundaries <= x (length S+1)."""
    b = np.zeros(s + 1, np.int32)
    interior = gene_start[1:-1]
    np.add.at(b, interior, 1)
    return np.cumsum(b, dtype=np.int32)


def _host_index_arrays(tcat: np.ndarray, gene_start: np.ndarray, width: int):
    """Window keys of every valid position, sorted by (k1, k2, pos) —
    numpy, with the window keys and the radix sort in C when the native
    library is present.  Returns (k1, k2, spos, nvalid)."""
    from ..io import native

    s = len(tcat)
    mult = np.uint32(winops.key_multiplier(width))
    use_k2 = winops.uses_second_key(width)
    m2 = np.uint32(winops.HASH_MULT2) if use_k2 else np.uint32(0)
    keys = np.empty(s, np.uint32)
    keys2 = np.zeros(s, np.uint32)
    tcat_c = np.ascontiguousarray(tcat, dtype=np.uint8)
    if not native.window_keys_native(tcat_c, width, mult, m2, keys, keys2):
        padded = np.concatenate(
            [tcat.astype(np.uint32), np.zeros(width - 1, np.uint32)]
        )
        with np.errstate(over="ignore"):
            keys[:] = 0
            for i in range(width):
                keys *= mult
                keys += padded[i : i + s]
            if use_k2:
                keys2[:] = 0
                for i in range(width):
                    keys2 *= m2
                    keys2 += padded[i : i + s]
    pos = np.arange(s, dtype=np.int32)
    cum = _boundary_cumsum_np(gene_start, s)
    endc = np.minimum(pos + width - 1, s)
    crossing = cum[endc] - cum[pos]
    valid = (pos + width - 1 < s) & (crossing == 0)
    nvalid = int(valid.sum())

    k1 = np.ascontiguousarray(keys[valid])
    k2 = np.ascontiguousarray(keys2[valid])
    spos = np.ascontiguousarray(pos[valid])
    if not native.sort_index_native(k1, k2, spos):
        order = np.lexsort((spos, k2, k1))
        k1, k2, spos = k1[order], k2[order], spos[order]
    return k1, k2, spos, nvalid


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """Host uint32/int32 array -> int32 device tensor of the same bytes."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)


# The device build's memory is bounded in two ways: window keys are
# computed BUILD_CHUNK positions at a time, and the valid windows are
# sorted in groups of whole top-key-byte buckets of at most SORT_SPAN
# windows each (a single bucket larger than that is sorted alone).
BUILD_CHUNK = 1 << 25
SORT_SPAN = 1 << 25


def _valid_windows(tcat: torch.Tensor, gene_start: torch.Tensor, nreal: int,
                   width: int) -> torch.Tensor:
    """(S,) bool on tcat's device: the window at p lies inside one gene and
    ends before nreal."""
    s = tcat.shape[0]
    dev = tcat.device
    # cum[x] = interior boundaries <= x; a window [p, p+W-1] spans one gene
    # iff no boundary lies in (p, p+W-1].
    cum = torch.zeros(s + 1, dtype=torch.int32, device=dev)
    interior = gene_start[1:-1].to(torch.int64).clamp(0, s)
    cum.index_add_(0, interior, torch.ones_like(interior, dtype=torch.int32))
    cum.cumsum_(0)
    valid = torch.empty(s, dtype=torch.bool, device=dev)
    for c0 in range(0, s, BUILD_CHUNK):
        c1 = min(s, c0 + BUILD_CHUNK)
        end = torch.arange(c0 + width - 1, c1 + width - 1, device=dev)
        valid[c0:c1] = (end < nreal) & (cum[end.clamp(max=s)] == cum[c0:c1])
    return valid


def _sorted_windows(tcat: torch.Tensor, gene_start: torch.Tensor, nreal: int,
                    width: int, keep_k2: bool = True):
    """The valid windows of tcat sorted by (key1, key2, position), each
    compared as uint32, on tcat's device.  Returns (skeys, skeys2, spos,
    nvalid): (nvalid,) int32 arrays (uint32 bit patterns for the keys;
    skeys2 is None unless keep_k2).

    Peak memory is about 26 bytes a valid window (22 without keep_k2)
    beside tcat and a fixed ~2 GiB: key1, key2, position and the top key
    byte of each valid window in position order, the three sorted outputs,
    and one sort group's work."""
    s = tcat.shape[0]
    dev = tcat.device
    valid = _valid_windows(tcat, gene_start, nreal, width)
    nvalid = int(valid.sum())
    use_k2 = winops.uses_second_key(width)
    upshift = sops.bucket_shift(width)  # top byte of the width's key range
    k1 = torch.empty(nvalid, dtype=torch.int32, device=dev)
    k2 = torch.zeros(nvalid, dtype=torch.int32, device=dev)
    pos = torch.empty(nvalid, dtype=torch.int32, device=dev)
    top = torch.empty(nvalid, dtype=torch.uint8, device=dev)
    per_top = torch.zeros(256, dtype=torch.int64, device=dev)
    off = 0
    for c0 in range(0, s, BUILD_CHUNK):
        lanes = torch.nonzero(valid[c0 : c0 + BUILD_CHUNK]).squeeze(1)
        n = lanes.numel()
        if n == 0:
            continue
        seg = tcat[c0 : c0 + BUILD_CHUNK + width - 1]
        key = winops.sliding_window_keys(seg, width)[lanes]
        k1[off : off + n] = pops.to_i32(key)
        t = sops.bucket_of(key, upshift, 8)
        top[off : off + n] = t.to(torch.uint8)
        per_top += torch.bincount(t, minlength=256)
        if use_k2:
            key2 = winops.sliding_window_keys(seg, width, winops.HASH_MULT2)[lanes]
            k2[off : off + n] = pops.to_i32(key2)
        pos[off : off + n] = (lanes + c0).to(torch.int32)
        off += n
    del valid

    # Each group holds whole top-byte buckets, and the groups follow in
    # bucket order, which is the unsigned key1 order: concatenated, the
    # sorted groups are sorted.  Within a group, the selected windows keep
    # position order; key1 and key2 are uint32 bit patterns, and
    # (key1 ^ 0x80000000) as a signed int32 times 2**32 plus key2 as
    # unsigned is an int64 whose signed order is the unsigned (key1, key2)
    # order; a stable sort keeps equal (key1, key2) in position order.  So
    # the order is exactly (key1, key2, position), the host build's.
    skeys = torch.empty_like(k1)
    skeys2 = torch.empty_like(k2) if keep_k2 else None
    spos = torch.empty_like(pos)
    groups, lo, acc = [], 0, 0
    for b, c in enumerate(per_top.tolist()):
        if acc and acc + c > SORT_SPAN:
            groups.append((lo, b))
            lo, acc = b, 0
        acc += c
    groups.append((lo, 256))
    off = 0
    for lo, hi in groups:
        sel = torch.nonzero((top >= lo) & (top <= hi - 1)).squeeze(1)  # uint8: no 256
        n = sel.numel()
        if n == 0:
            continue
        key = ((k1[sel] ^ -(1 << 31)).to(torch.int64) * (1 << 32)
               + (k2[sel].to(torch.int64) & pops.M32))
        src = sel[torch.sort(key, stable=True)[1]]
        del key, sel
        skeys[off : off + n] = k1[src]
        spos[off : off + n] = pos[src]
        if keep_k2:
            skeys2[off : off + n] = k2[src]
        off += n
    return skeys, skeys2, spos, nvalid


def _index_arrays(tcat: torch.Tensor, gene_start: torch.Tensor, nreal: int, width: int):
    """Device index build, the JAX function's twin: window keys at every
    position, validity from the gene-boundary structure, the valid
    windows sorted (``_sorted_windows``), on tcat's device.

    nreal is the count of real (non-padding) bases; windows must end inside
    it.  Returns (skeys, skeys2, spos, nvalid) as the JAX function does:
    (S,) int32 arrays (uint32 bit patterns for the keys) whose first nvalid
    entries are the valid windows sorted by (key1, key2, position), each
    compared as uint32, followed by an invalid tail of (0xFFFFFFFF,
    0xFFFFFFFF, -1) entries."""
    s = tcat.shape[0]
    *sorted_, nvalid = _sorted_windows(tcat, gene_start, nreal, width)
    out = [torch.full((s,), -1, dtype=torch.int32, device=tcat.device) for _ in range(3)]
    for o, v in zip(out, sorted_):
        o[:nvalid] = v
    return (*out, nvalid)


def build_target_index(ts: TargetSet, width: int, device, device_build: bool = False,
                       keep_k2: bool = True) -> TargetIndex:
    """Compile a TargetSet into a TargetIndex on ``device``.

    The default host build runs the window keys and the (k1, k2, pos) sort
    on the host and uploads the sorted arrays; ``device_build=True``
    uploads the gene stream, computes and sorts on the device
    (``_sorted_windows``) and packs the stream there
    (``pops.pack_stream_device``).  Both give the same skeys, spos and
    tpacked.  A device
    build with ``keep_k2=False`` (a mesh shard's) keeps no second key
    word, and then has no index file and no search aux."""
    device = torch.device(device)
    s = int(ts.gene_start[-1])
    if s > np.iinfo(np.int32).max:
        raise NotImplementedError(
            "single-shard target index limited to 2**31-1 positions; "
            "shard by gene range (pipeline.run_matching_gene_sharded) for "
            "larger databases"
        )
    gene_start_np = np.asarray(ts.gene_start, dtype=np.int64).astype(np.int32)
    gene_start = _upload(gene_start_np, device)
    t0 = time.perf_counter()
    skeys2 = host_arrays = None
    if device_build:
        tcat = torch.from_numpy(np.ascontiguousarray(ts.tcat, dtype=np.uint8)).to(device)
        _sync(device)
        t_tcat = time.perf_counter()
        skeys, skeys2, spos, nvalid = _sorted_windows(tcat, gene_start, s, width, keep_k2)
        if nvalid == 0:
            skeys, spos = (torch.tensor([-1], dtype=torch.int32, device=device)
                           for _ in range(2))
            skeys2 = skeys.clone() if keep_k2 else None
        _sync(device)
        t_keys = time.perf_counter()
        tpacked = pops.pack_stream_device(tcat, BUILD_CHUNK)
        del tcat
        _sync(device)
        t_pack = time.perf_counter()
        timings = {"device_keys_sort_s": t_keys - t_tcat, "pack_s": t_pack - t_keys,
                   "upload_s": t_tcat - t0}
    else:
        k1, k2, sp, nvalid = _host_index_arrays(np.asarray(ts.tcat), gene_start_np, width)
        if nvalid == 0:
            k1 = np.array([INVALID_KEY], np.uint32)
            k2 = np.array([INVALID_KEY], np.uint32)
            sp = np.array([-1], np.int32)
        host_arrays = (k1, k2, sp)
        t_keys = time.perf_counter()
        tpacked_np = pops.pack_stream(np.asarray(ts.tcat))
        t_pack = time.perf_counter()
        skeys = _upload(k1, device)
        spos = _upload(sp, device)
        tpacked = _upload(tpacked_np, device)
        _sync(device)
        t_up = time.perf_counter()
        timings = {"host_keys_sort_s": t_keys - t0, "pack_s": t_pack - t_keys,
                   "upload_s": t_up - t_pack}
    return TargetIndex(
        tpacked=tpacked, gene_start=gene_start, gene_start_np=gene_start_np,
        skeys=skeys, spos=spos, width=width, num_valid=nvalid, num_bases=s,
        skeys2=skeys2, host_arrays=host_arrays, build_timings=timings,
    )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
