"""Scale smoke test, mirroring the reference's tests/bigtest/test.sh (twin
of ``muscato_tpu/bench/bigtest.py``): gendat data (default 100k reads x
100k genes) through the full ``muscato_torch`` driver with
Windows=10,30,50,70, WindowWidth=20, MaxReadLength=200
(the reference's tests/bigtest/test.sh:6-13).

    python -m muscato_tpu_torch.bench.bigtest [--NumRead N] [--NumGene N]
        [--ReadLen N] [--GeneLen N] [--Dir D] [--device cuda|cpu]

Prints the time of each stage (gendat, prep_targets, the driver run), the
result row count, and the run's log files.  Asked for ``cuda`` without a
CUDA device it raises.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--NumRead", type=int, default=100_000)
    p.add_argument("--NumGene", type=int, default=100_000)
    p.add_argument("--ReadLen", type=int, default=100)
    p.add_argument("--GeneLen", type=int, default=1_000)
    p.add_argument("--Dir", type=str, default="bigtest_out")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu, where the kernels' plain twins run")
    ns = p.parse_args(argv)

    from .. import config as config_mod
    from ..device import resolve_device
    from ..engine import driver
    from ..io import targets
    from . import gendat

    dev = resolve_device(ns.device)
    os.makedirs(ns.Dir, exist_ok=True)
    t0 = time.time()
    reads_path, genes_path = gendat.generate(
        ns.NumRead, ns.ReadLen, ns.NumGene, ns.GeneLen, out_dir=ns.Dir
    )
    print(f"gendat: {time.time()-t0:.1f}s", flush=True)

    t0 = time.time()
    seq_path, ids_path = targets.prep_targets(genes_path)
    print(f"prep_targets: {time.time()-t0:.1f}s", flush=True)

    cfg = config_mod.Config(
        ReadFileName=reads_path,
        GeneFileName=seq_path,
        GeneIdFileName=ids_path,
        ResultsFileName=os.path.join(ns.Dir, "results.txt"),
        Windows=[10, 30, 50, 70],
        WindowWidth=20,
        MaxReadLength=200,
        TempDir=os.path.join(ns.Dir, "tmp"),
        LogDir=os.path.join(ns.Dir, "logs"),
    )
    config_mod.apply_defaults(cfg)
    t0 = time.time()
    driver.run(cfg, device=dev)
    dt = time.time() - t0
    with open(cfg.ResultsFileName, "rb") as f:
        nlines = sum(1 for _ in f)
    print(
        f"full run: {dt:.1f}s ({ns.NumRead/dt:,.0f} reads/s end-to-end), "
        f"{nlines} result rows",
        flush=True,
    )
    # Per-stage breakdown (host prep and report against device matching)
    # from the run's log files.
    logroot = cfg.LogDir  # the driver rewrote it to LogDir/<uuid>
    for name in ("muscato_prep.log", "muscato_index.log",
                 "muscato_screen.log", "muscato_report.log"):
        path = os.path.join(logroot, name)
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    print("  " + line.rstrip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
