"""Target index on the device (port of ``muscato_tpu/engine/index.py``'s
host build).

The targets are compiled once into the sorted window-key index that read
batches probe: the window key of every valid window position, sorted as
uint32 (ties by position), with the positions alongside.  A window
position p is valid iff the whole window lies inside one gene.  Keys and
sort run on the host (in C when the native library is present) and the
arrays are uploaded to an explicit device:

  tpacked    (S/8+pad,) int32  nibble-packed gene stream (uint32 bit patterns)
  gene_start (G+1,) int32      gene offsets into the stream
  skeys      (V,)  int32       sorted window keys (uint32 bit patterns)
  spos       (V,)  int32       the window positions, aligned with skeys

The second hash word never goes to the device: the probe joins on key1
alone, and key1 collisions between distinct wide k-mers die in the
byte-true verify.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..io.targets import TargetSet

from ..ops import packed as pops
from ..ops import windows as winops

INVALID_KEY = np.uint32(0xFFFFFFFF)


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
    build_timings: dict | None = field(default=None, repr=False)
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


def build_target_index(ts: TargetSet, width: int, device) -> TargetIndex:
    """Compile a TargetSet into a TargetIndex on ``device``."""
    device = torch.device(device)
    s = int(ts.gene_start[-1])
    if s > np.iinfo(np.int32).max:
        raise NotImplementedError(
            "gene-range sharding (targets above 2**31-1 bases) is not "
            "ported to muscato_tpu_torch yet"
        )
    gene_start_np = np.asarray(ts.gene_start, dtype=np.int64).astype(np.int32)
    t0 = time.perf_counter()
    k1, _k2, sp, nvalid = _host_index_arrays(np.asarray(ts.tcat), gene_start_np, width)
    if nvalid == 0:
        k1 = np.array([INVALID_KEY], np.uint32)
        sp = np.array([-1], np.int32)
    t_host = time.perf_counter()
    tpacked_np = pops.pack_stream(np.asarray(ts.tcat))
    t_pack = time.perf_counter()
    skeys = _upload(k1, device)
    spos = _upload(sp, device)
    tpacked = _upload(tpacked_np, device)
    gene_start = _upload(gene_start_np, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    timings = {
        "host_keys_sort_s": t_host - t0,
        "pack_s": t_pack - t_host,
        "upload_s": time.perf_counter() - t_pack,
    }
    return TargetIndex(
        tpacked=tpacked, gene_start=gene_start, gene_start_np=gene_start_np,
        skeys=skeys, spos=spos, width=width, num_valid=nvalid, num_bases=s,
        build_timings=timings,
    )
