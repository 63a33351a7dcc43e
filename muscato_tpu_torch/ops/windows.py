"""Window keys and the dinucleotide gate (port of
``muscato_tpu/ops/windows.py``).

Window content over the 5-letter code alphabet is the probe key: base-5
Horner packing is exact up to width 13; wider windows use an odd 32-bit
multiplier (a polynomial hash mod 2**32) paired with a second hash.

Keys are uint32 values held in int64 lanes (torch has no shifts on
uint32): every Horner step multiplies through ``packed.mulmod32``, whose
partial products stay below 2**63, so no step relies on int64 wrap.
"""

from __future__ import annotations

import numpy as np
import torch

from .packed import M32, mulmod32

NBASE = 5
EXACT_WIDTH_LIMIT = 13  # 5**13 = 1_220_703_125 < 2**31
HASH_MULT = np.uint32(0x9E3779B1)  # odd => injective per-step mixing
HASH_MULT2 = np.uint32(0x85EBCA77)  # second, decorrelated hash for wide windows


def key_multiplier(width: int) -> np.uint32:
    return np.uint32(NBASE) if width <= EXACT_WIDTH_LIMIT else HASH_MULT


def uses_second_key(width: int) -> bool:
    """Wide windows pair the primary hash with a second 32-bit hash."""
    return width > EXACT_WIDTH_LIMIT


def _horner(columns, n: int, mult, device) -> torch.Tensor:
    """sum(col_i * mult**(w-1-i)) mod 2**32 over the width's columns."""
    mult = int(mult)
    key = torch.zeros(n, dtype=torch.int64, device=device)
    for col in columns:
        key = (mulmod32(key, mult) + col.to(torch.int64)) & M32
    return key


def window_keys_at(codes: torch.Tensor, q1: int, width: int, mult=None) -> torch.Tensor:
    """Keys of the width-``width`` window starting at column q1 of each row.

    codes: (R, L) uint8/int32.  Returns (R,) int64 holding uint32 values.
    Rows whose length is shorter than q1+width produce garbage keys;
    callers mask by length."""
    if mult is None:
        mult = key_multiplier(width)
    w = codes[:, q1 : q1 + width]
    return _horner((w[:, i] for i in range(width)), codes.shape[0], mult, codes.device)


def sliding_window_keys(tcat: torch.Tensor, width: int, mult=None) -> torch.Tensor:
    """Keys of the window starting at every position of a 1-D code array.

    tcat: (S,) uint8.  Returns (S,) int64 holding uint32 values; the last
    width-1 entries read zero-padding and are masked out by validity
    downstream."""
    if mult is None:
        mult = key_multiplier(width)
    s = tcat.shape[0]
    padded = torch.nn.functional.pad(tcat.to(torch.int64), (0, width - 1))
    return _horner((padded[i : i + s] for i in range(width)), s, mult, tcat.device)


def dinucleotide_counts(codes: torch.Tensor, q1: int, width: int) -> torch.Tensor:
    """Distinct adjacent-pair count within each row's [q1, q1+width) window.

    codes: (R, L).  Returns (R,) int32 in [0, 25]."""
    w = codes[:, q1 : q1 + width].to(torch.int32)
    pairs = w[:, :-1] * NBASE + w[:, 1:]  # (R, width-1)
    bins = torch.arange(NBASE * NBASE, dtype=torch.int32, device=codes.device)
    present = (pairs[:, :, None] == bins[None, None, :]).any(dim=1)  # (R, 25)
    return present.sum(dim=1).to(torch.int32)
