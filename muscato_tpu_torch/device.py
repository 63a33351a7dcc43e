"""Device selection: an explicit choice, never a silent fallback."""

from __future__ import annotations

import torch


def resolve_device(name) -> torch.device:
    """``torch.device`` for ``name`` ("cuda", "cuda:0", "cpu", or a device).

    Raises when a CUDA device is asked for and none is available: nothing
    here picks the CPU on its own."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is False"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev
