"""Microbench: the dedup verify's cost per lane on the card (twin of
``muscato_tpu/bench/micro_verify.py``).

Times ``ops/packed.py:verify_diagonals_packed``, the dedup verify (the
B3 gene lookup, the B4 row gather and the B7 kernel of its SWAR body),
over N lanes with the flagship's table sizes: a 100M-base
target stream (its row view for the B4 row gather, its gene block table
for the B3 gene lookup), 4M packed reads of 100 bases, width 20, PMatch
0.96, windows 10,30,50,70.  The modes attribute the cost:

  full, const_read, const_diag  random (read, diagonal) lanes; const_read
                                sends every lane to read 0, const_diag
                                every lane to one diagonal;
  tuned full, tuned const_read  lanes sorted by diagonal, as the engine
                                feeds them: the target rows on B4 and the
                                gene lookup on B3 stream in order; each
                                also with the SWAR body alone on the same
                                fetched rows: ``verify_diagonals_swar``
                                (the B7 kernel on the card) beside its
                                plain twin ``verify_diagonals_swar_torch``;
  read-row gather alone         ``index_select`` of the lanes' read rows;
  sort + B4 row ride            the same rows sorted by read (lane ids
                                carried), fetched by B4, put back.

    python -m muscato_tpu_torch.bench.micro_verify [n_millions]
        [--device cuda|cpu] [--Bases S] [--Reads R]

Prints ms and ns/lane for each, the best of 6 runs cycling over three lane
sets (one synchronise a run).  Asked for ``cuda`` without a CUDA device it
raises.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

WIDTH = 20
MAX_RL = 100
WINDOWS = (10, 30, 50, 70)


def timeit(fn, sync, reps: int = 3) -> float:
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def tables(dev, s: int, r: int, seed: int = 0) -> dict:
    """Random packed reads and target stream at the given sizes, genes of
    1,000 bases, and the engine's derived tables, on ``dev``."""
    import torch

    from ..ops import packed as pops
    from ..ops import verify as vops

    rng = np.random.default_rng(seed)
    nw = pops.packed_width(MAX_RL)
    rpacked = torch.from_numpy(rng.integers(0, 2**32, (r, nw), dtype=np.uint64)
                               .astype(np.uint32).view(np.int32)).to(dev)
    tpacked = torch.from_numpy(rng.integers(0, 2**32, s // 8 + 4, dtype=np.uint64)
                               .astype(np.uint32).view(np.int32)).to(dev)
    gene_start = np.arange(0, s + 1000, 1000, dtype=np.int64)
    gene_start[-1] = s
    gb, steps = pops.build_gene_block(gene_start, s)
    return dict(
        rpacked=rpacked, lengths=torch.full((r,), MAX_RL, dtype=torch.int32, device=dev),
        gene_start=torch.from_numpy(gene_start.astype(np.int32)).to(dev),
        budget=torch.from_numpy(vops.mismatch_budget_table(0.96, MAX_RL)).to(dev),
        trows=pops.build_trows(tpacked, nw, s), gblock=torch.from_numpy(gb).to(dev),
        gsteps=steps, s=s, r=r,
    )


def measure(dev, n: int, tb: dict, log=print) -> dict:
    """ms and ns/lane of each mode over n lanes against the tables ``tb``;
    returns {mode: {"ms", "ns_per_lane"}}."""
    import torch

    from ..ops import gather
    from ..ops import packed as pops

    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    rng = np.random.default_rng(1)
    s, r = tb["s"], tb["r"]

    def mk(sort_d):
        rr = rng.integers(0, r, n).astype(np.int32)
        dd = rng.integers(0, s - 2 * MAX_RL, n)
        if sort_d:
            dd = np.sort(dd)
        return torch.from_numpy(rr).to(dev), torch.from_numpy(dd.astype(np.int32)).to(dev)

    def lanes_of(rr, dd, mode):
        if mode == "const_read":
            rr = torch.zeros_like(rr)
        elif mode == "const_diag":
            dd = torch.full_like(dd, 12345)
        return rr, dd

    def verify(rr, dd, mode):
        rr, dd = lanes_of(rr, dd, mode)
        return pops.verify_diagonals_packed(
            rr, dd, tb["rpacked"], tb["lengths"], tb["gene_start"], tb["budget"], WINDOWS,
            WIDTH, s, tb["trows"], tb["gblock"], tb["gsteps"])

    def swar_args(rr, dd, mode):
        """The SWAR body's arguments for these lanes, fetched once."""
        rr, dd = lanes_of(rr, dd, mode)
        _, gstart, gend, t_rows = pops.diagonal_fetch(
            rr, dd, tb["gene_start"], tb["gblock"], tb["gsteps"], tb["trows"], s)
        return (rr, dd, t_rows, tb["rpacked"], tb["lengths"], gstart, gend, tb["budget"],
                WINDOWS)

    def cycle(lanes, f):
        state = [0]

        def go():
            rr, dd = lanes[state[0] % 3]
            state[0] += 1
            return f(rr, dd)

        return go

    out = {}

    def record(label, best, unit="lane"):
        out[label] = {"ms": best * 1e3, f"ns_per_{unit}": best / n * 1e9}
        log(f"{label}: {best * 1e3:.3f}ms -> {best / n * 1e9:.2f} ns/{unit}", flush=True)

    lanes = [mk(False) for _ in range(3)]
    for mode in ("full", "const_read", "const_diag"):
        f = lambda rr, dd, m=mode: verify(rr, dd, m)
        f(*lanes[0])
        record(mode, timeit(cycle(lanes, f), sync, reps=6))

    log("--- tuned (d-sorted lanes: B4 target rows, B3 gene lookup) ---", flush=True)
    slanes = [mk(True) for _ in range(3)]
    for mode in ("full", "const_read"):
        f = lambda rr, dd, m=mode: verify(rr, dd, m)
        f(*slanes[0])
        record(f"tuned read={mode}", timeit(cycle(slanes, f), sync, reps=6))
        args = [swar_args(rr, dd, mode) for rr, dd in slanes]
        for body in (pops.verify_diagonals_swar, pops.verify_diagonals_swar_torch):
            state = [0]

            def go(body=body):
                state[0] += 1
                return body(*args[state[0] % 3], width=WIDTH, smax=s)

            go()
            record(f"tuned read={mode} SWAR body, {body.__name__}", timeit(go, sync, reps=6))
        del args

    rp = tb["rpacked"]
    g = lambda rr, dd: rp.index_select(0, rr.clamp(0, r - 1))
    g(*slanes[0])
    record("read-row gather alone (index_select)", timeit(cycle(slanes, g), sync, reps=6),
           unit="row")

    def sorted_ride(rr, dd):
        rs, lane = torch.sort(rr.clamp(0, r - 1), stable=True)
        rows, _ = gather.monotone_gather_rows(rp, rs)
        inv = torch.empty_like(lane)
        inv[lane] = torch.arange(n, dtype=lane.dtype, device=dev)
        return rows[inv]

    got = sorted_ride(*slanes[0])
    if not torch.equal(got, g(*slanes[0])):
        raise AssertionError("sort + B4 row ride: rows differ from index_select")
    record("sort + B4 row ride", timeit(cycle(slanes, sorted_ride), sync, reps=6), unit="row")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("n_millions", nargs="?", type=float, default=1.0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu, where the wrappers run their twins")
    p.add_argument("--Bases", type=int, default=100_000_000)
    p.add_argument("--Reads", type=int, default=4_000_000)
    ns = p.parse_args(argv)

    import torch

    from ..device import resolve_device

    dev = resolve_device(ns.device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    n = int(ns.n_millions * 1e6)
    tb = tables(dev, ns.Bases, ns.Reads)
    print(f"device {kind}: tables ready: trows {tuple(tb['trows'].shape)} steps "
          f"{tb['gsteps']}; {n} lanes", flush=True)
    measure(dev, n, tb)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
