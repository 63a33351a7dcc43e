"""Command-line entry point ``muscato_torch`` (the PyTorch/CUDA twin of
``muscato``).

It takes the same flags and config file as ``muscato`` (parsed by
``muscato_tpu.config``), plus ``-device=`` (default ``cuda``; ``cpu``
runs the kernels' plain PyTorch twins).  ``muscato_prep_targets`` and
``muscato_gendat`` are framework-free and serve both packages as they are.
"""

from __future__ import annotations

import sys


def _split_device(argv):
    """Remove a -device=X / --device X flag from argv; return (argv, X)."""
    rest, device = [], "cuda"
    it = iter(argv)
    for a in it:
        if a.lstrip("-") == "device":
            device = next(it, device)
        elif a.lstrip("-").startswith("device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    return rest, device


def main_muscato(argv=None) -> int:
    from muscato_tpu import config as config_mod

    from .engine import driver

    argv, device = _split_device(sys.argv[1:] if argv is None else argv)
    cfg = config_mod.parse_cli(argv)
    config_mod.apply_defaults(cfg)
    driver.run(cfg, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main_muscato())
