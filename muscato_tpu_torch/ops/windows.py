"""Window-key constants (numpy copies of ``muscato_tpu/ops/windows.py``).

Window content over the 5-letter code alphabet is the probe key: base-5
Horner packing is exact up to width 13; wider windows use an odd 32-bit
multiplier (a polynomial hash mod 2**32) paired with a second hash.
"""

from __future__ import annotations

import numpy as np

NBASE = 5
EXACT_WIDTH_LIMIT = 13  # 5**13 = 1_220_703_125 < 2**31
HASH_MULT = np.uint32(0x9E3779B1)  # odd => injective per-step mixing
HASH_MULT2 = np.uint32(0x85EBCA77)  # second, decorrelated hash for wide windows


def key_multiplier(width: int) -> np.uint32:
    return np.uint32(NBASE) if width <= EXACT_WIDTH_LIMIT else HASH_MULT


def uses_second_key(width: int) -> bool:
    """Wide windows pair the primary hash with a second 32-bit hash."""
    return width > EXACT_WIDTH_LIMIT
