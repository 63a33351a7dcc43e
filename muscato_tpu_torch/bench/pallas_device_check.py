"""First check on a new card: build the CUDA kernels that replace the JAX
package's Pallas kernels (B1-B6, ``muscato_tpu_torch/csrc``) and run each
against its plain PyTorch twin (twin of
``muscato_tpu/bench/pallas_device_check.py``; the module keeps that name
so that a reader finds its counterpart).  The twins stand in for the JAX
check's NumPy oracles: tests/test_torch_kernels.py holds each twin
against the JAX package's oracle.

The tests run on the CPU, where every wrapper runs its twin; only this
check (and chip_smoke.py) shows that the kernels build with nvcc for
sm_90a and compute their twins' values on the card.  Each kernel runs at
small shapes (the JAX check's) and at the flagship's main-path shapes
(98.1M index keys, 16.8M queries, ~10M pair lanes, a (2**20, 22) row
gather of the target rows, a (2**22, 13) packed read batch), with the
cases the engine feeds them: duplicate key runs, unsorted gaps, and a
dead tail of empty slots.  Results must be exactly equal.

    python -m muscato_tpu_torch.bench.pallas_device_check [--device cuda|cpu]
        [--Shapes small|main|both]

Prints one ``PASS``/``FAIL`` line per kernel and shape, ``PALLAS_RESULTS
{json}``, and exits nonzero on any mismatch or fault.  Asked for
``cuda`` without a CUDA device it raises.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

# Shapes: (B3 table, B3 lanes, B3 lane span), (B4 rows, B4 words, B4 lanes),
# (B1 keys, B1 queries, key range), (B5 reads, read length),
# (B2/B6 slots, most pairs a slot).  "main" is the flagship batch's.
SHAPES = {
    "small": dict(gather=(1 << 20, 1 << 17, 1 << 19), rows=(1 << 14, 24, 1 << 15),
                  join=(1 << 18, 1 << 15, 1 << 20), windows=(4096, 64),
                  expand=(1 << 16, 6)),
    "main": dict(gather=(98_100_000, 11_000_000, 98_100_000),
                 rows=(1_562_500, 22, 1 << 20),
                 join=(98_100_000, 16_777_216, 1 << 32), windows=(1 << 22, 100),
                 expand=(1 << 22, 5)),
}


def _to_dev(a: np.ndarray, dev):
    import torch

    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _equal(name: str, got, exp: np.ndarray) -> None:
    got = got.cpu().numpy()
    if exp.dtype == np.uint32:
        got = got.view(np.uint32)
    if got.shape != exp.shape or not np.array_equal(got, exp):
        bad = np.flatnonzero(got.reshape(-1) != exp.reshape(-1)) if got.shape == exp.shape else []
        raise AssertionError(
            f"{name}: {len(bad)} of {exp.size} differ (first at {bad[:1]}), shapes "
            f"{got.shape} {exp.shape}")


def check_gather(rng, dev, n_table, n_idx, span):
    from ..ops import gather

    table = rng.integers(-(1 << 31), 1 << 31, n_table, dtype=np.int64).astype(np.int32)
    idx = np.sort(rng.integers(0, min(span, n_table), n_idx)).astype(np.int32)
    idx[n_idx // 3 : n_idx // 3 + 1000] = idx[n_idx // 3 : n_idx // 3 + 1000][::-1]  # a step-back run
    t, i = _to_dev(table, dev), _to_dev(idx, dev)
    out, of = gather.monotone_gather(t, i)
    assert of == 0
    _equal("monotone_gather vs twin", out, gather.monotone_gather_torch(t, i)[0].cpu().numpy())


def check_gather_rows(rng, dev, nrows, ncols, n_idx):
    from ..ops import gather

    table = rng.integers(-(1 << 31), 1 << 31, (nrows, ncols), dtype=np.int64).astype(np.int32)
    ridx = np.sort(rng.integers(0, nrows, n_idx)).astype(np.int32)
    ridx[-n_idx // 8:] = nrows - 1  # a dead tail on the last row
    t, r = _to_dev(table, dev), _to_dev(ridx, dev)
    out, of = gather.monotone_gather_rows(t, r)
    assert of == 0
    _equal("monotone_gather_rows vs twin", out,
           gather.monotone_gather_rows_torch(t, r)[0].cpu().numpy())


def check_join(rng, dev, n_keys, n_queries, key_range):
    from ..ops import join

    skeys = np.sort(rng.integers(0, key_range, n_keys, dtype=np.int64)).astype(np.uint32)
    skeys[n_keys // 2 : n_keys // 2 + 20_000] = skeys[n_keys // 2]  # a long equal-key run
    qk = rng.integers(0, key_range, n_queries, dtype=np.int64).astype(np.uint32)
    qk[: n_queries // 4] = rng.choice(skeys, n_queries // 4)  # hits
    qk[-8:] = 0xFFFFFFFF
    qk = np.sort(qk)
    s, q = _to_dev(skeys, dev), _to_dev(qk, dev)
    lo, cnt, of = join.sorted_join(s, q)
    assert of == 0
    tlo, tcnt, _ = join.sorted_join_torch(s, q)
    _equal("sorted_join lo vs twin", lo, tlo.cpu().numpy())
    _equal("sorted_join count vs twin", cnt, tcnt.cpu().numpy())


def check_windows(rng, dev, nreads, read_len):
    from ..ops import packed, window_queries as wq

    codes = rng.integers(0, 5, (nreads, read_len), dtype=np.uint8)
    lengths = rng.integers(read_len // 4, read_len + 1, nreads).astype(np.int32)
    lengths[: nreads // 2] = read_len
    rp = packed.pack_rows(_to_dev(codes, dev))
    ln = _to_dev(lengths, dev)
    flagship = tuple(q for q in (10, 30, 50, 70) if q + 20 <= read_len)
    cases = ((0, 10), 12, 2), (flagship, 20, 3), ((0, 5, read_len - 13), 13, 0)
    for q1s, width, min_dinuc in cases:
        got = wq.window_queries(rp, ln, q1s, width=width, min_dinuc=min_dinuc)
        twin = wq.window_queries_torch(rp, ln, q1s, width=width, min_dinuc=min_dinuc)
        for part, g, t in zip(("key1", "key2", "valid"), got, twin):
            _equal(f"window_queries {part} (width {width}) vs twin", g, t.cpu().numpy())


def check_expand(rng, dev, m, most, subchunk):
    from ..ops import expand

    name = "expand_owners_sub" if subchunk else "expand_owners"
    counts = rng.integers(0, most, m).astype(np.int64)
    counts[m // 3 : m // 3 + 5000] = 0  # a run of empty slots
    lo = rng.integers(0, 1 << 26, m).astype(np.int32)
    qid = rng.integers(0, 1 << 24, m).astype(np.int32)
    # Then the engine's shape: the compacted slots end in a long dead tail
    # (counts 0, oexcl == total) and pair_cap is well above the total.
    for tail in (False, True):
        if tail:
            counts[m // 8:] = 0
        oexcl = (np.cumsum(counts) - counts).astype(np.int32)
        total = int(counts.sum())
        cap = total if not tail else 2 * total + 4096
        o, l, q = _to_dev(oexcl, dev), _to_dev(lo, dev), _to_dev(qid, dev)
        gq, gs = expand.expand_owners(o, l, q, pair_cap=cap, subchunk=subchunk)
        tq, ts = expand.expand_owners_torch(o, l, q, pair_cap=cap)
        label = f"{name} ({'dead tail' if tail else 'live slots'})"
        _equal(label + " qid vs twin", gq, tq.cpu().numpy())
        _equal(label + " sidx vs twin", gs, ts.cpu().numpy())


def run(dev, shapes=("small", "main"), log=print) -> dict:
    """Run every kernel at each of ``shapes`` on ``dev``; returns
    {"<kernel> <shape>": true/false}."""
    results = {}
    for shape in shapes:
        sh = SHAPES[shape]
        checks = {
            "monotone_gather": lambda rng: check_gather(rng, dev, *sh["gather"]),
            "monotone_gather_rows": lambda rng: check_gather_rows(rng, dev, *sh["rows"]),
            "sorted_join": lambda rng: check_join(rng, dev, *sh["join"]),
            "window_queries": lambda rng: check_windows(rng, dev, *sh["windows"]),
            "expand_owners": lambda rng: check_expand(rng, dev, *sh["expand"], False),
            "expand_owners_sub": lambda rng: check_expand(rng, dev, *sh["expand"], True),
        }
        for seed, (name, fn) in enumerate(checks.items()):
            key = f"{name} {shape}"
            t0 = time.perf_counter()
            try:
                fn(np.random.default_rng(seed + 1))
                results[key] = True
                log(f"PASS {key} ({time.perf_counter() - t0:.1f}s)", flush=True)
            except Exception as e:  # loud, per kernel
                results[key] = False
                log(f"FAIL {key}: {type(e).__name__}: {e}", flush=True)
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu, where the wrappers run their twins")
    p.add_argument("--Shapes", choices=("small", "main", "both"), default="both")
    ns = p.parse_args(argv)

    import torch

    from ..device import resolve_device
    from ..ops import _lib

    dev = resolve_device(ns.device)
    if dev.type == "cuda":
        t0 = time.perf_counter()
        kern = _lib.kernels()
        print(f"device={dev} kind={torch.cuda.get_device_name(dev)}; kernels {kern.path} "
              f"(built in {kern.build_s:.1f}s, loaded in {time.perf_counter() - t0:.1f}s)",
              flush=True)
    else:
        print("device=cpu: every wrapper runs its plain twin", flush=True)
    shapes = ("small", "main") if ns.Shapes == "both" else (ns.Shapes,)
    results = run(dev, shapes)
    failures = sum(not ok for ok in results.values())
    print("PALLAS_RESULTS " + json.dumps(results), flush=True)
    print(f"{'OK' if not failures else 'FAILURES'}: {failures} failed", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
