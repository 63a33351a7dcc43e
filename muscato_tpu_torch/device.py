"""Device selection: an explicit choice, never a silent fallback."""

from __future__ import annotations

import os

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


def rank_device(name) -> torch.device:
    """This process's device for ``name``: as ``resolve_device``, except
    that a bare "cuda" names the card ``cuda:{LOCAL_RANK}`` (torchrun sets
    the variable; 0 when it is unset), one card a process."""
    dev = resolve_device(name)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev
