"""Command-line entry point ``muscato_torch`` (the PyTorch/CUDA twin of
``muscato``).

It takes the same flags and config file as ``muscato`` (parsed by the
port's copy of its config module, ``muscato_tpu_torch.config``), plus
``-device=`` (default ``cuda``; ``cpu`` runs the kernels' plain PyTorch
twins).  ``muscato_torch_prep_targets`` and ``muscato_torch_gendat`` are
the port's ``muscato_prep_targets`` and ``muscato_gendat``: the same
flags, and the same files.
"""

from __future__ import annotations

import argparse
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
    from . import config as config_mod

    from .engine import driver

    argv, device = _split_device(sys.argv[1:] if argv is None else argv)
    cfg = config_mod.parse_cli(argv)
    config_mod.apply_defaults(cfg)
    driver.run(cfg, device=device)
    return 0


def main_prep_targets(argv=None) -> int:
    p = argparse.ArgumentParser(prog="muscato_torch_prep_targets")
    p.add_argument("-rev", "--rev", action="store_true", help="Include reverse complement sequences")
    p.add_argument("genefile", nargs=1)
    ns = p.parse_args(argv)

    from .io import targets

    seq_path, ids_path = targets.prep_targets(ns.genefile[0], rev=ns.rev)
    sys.stderr.write(f"Gene sequence file: {seq_path}\n")
    sys.stderr.write(f"Gene ids file: {ids_path}\n")
    return 0


def main_gendat(argv=None) -> int:
    p = argparse.ArgumentParser(prog="muscato_torch_gendat")
    p.add_argument("-NumRead", "--NumRead", type=int, default=10000)
    p.add_argument("-ReadLen", "--ReadLen", type=int, default=100)
    p.add_argument("-NumGene", "--NumGene", type=int, default=10000)
    p.add_argument("-GeneLen", "--GeneLen", type=int, default=1000)
    p.add_argument("-Dir", "--Dir", type=str, default=".")
    p.add_argument("-Seed", "--Seed", type=int, default=0)
    ns = p.parse_args(argv)

    from .bench import gendat

    gendat.generate(
        num_read=ns.NumRead, read_len=ns.ReadLen, num_gene=ns.NumGene,
        gene_len=ns.GeneLen, out_dir=ns.Dir, seed=ns.Seed,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main_muscato())
