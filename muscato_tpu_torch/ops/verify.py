"""Mismatch budget (numpy copy of ``muscato_tpu/ops/verify.py``)."""

from __future__ import annotations

import numpy as np


def mismatch_budget_table(pmatch: float, max_read_length: int) -> np.ndarray:
    """budget[L] = int((1 - pmatch) * L), float64, truncated toward zero —
    bit-identical to Go's int((1-PMatch)*float64(len)) (confirm main.go:198)."""
    ls = np.arange(max_read_length + 1, dtype=np.float64)
    return np.trunc((np.float64(1.0) - np.float64(pmatch)) * ls).astype(np.int32)
