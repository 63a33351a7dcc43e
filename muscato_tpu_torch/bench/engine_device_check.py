"""Engine-shaped kernel validation on the card (twin of
``muscato_tpu/bench/engine_device_check.py``).

Kernel checks on synthetic inputs (``bench/pallas_device_check.py``) can
pass while the engine's own inputs fail: the compacted slot arrays carry
a dead tail, and the probe and expand emit skewed runs and duplicate keys
that synthetic inputs miss.  This check runs the real engine end to end
on a realistic workload, once per path, and holds each path's MatchResult
to the CPU run of the same inputs, where every kernel wrapper runs its
plain PyTorch twin (the stand-in for the JAX check's XLA-only run).

    python -m muscato_tpu_torch.bench.engine_device_check [--NumRead N]
        [--ReadLen N] [--NumGene N] [--GeneLen N] [--ReadBatch N]
        [--device cuda|cpu]

The paths (``PATHS``): the engine's own probe choice (auto); the
default, the sorted join (B5, B1, B2, B3, B4); MUSCATO_PJOIN=0
(the sort-merge probe); MUSCATO_PEXPAND_SUB=1 (B6); both switches;
NoDedup (the streaming expand); probe="search" in direct and in binary
mode.  A kernel fault fails its path loudly: nothing falls back.  Prints
one ``PASS``/``FAIL engine[path]`` line per path, then ``ENGINE_RESULTS
{json}`` (path -> true/false) and ``ENGINE_DETAIL {json}``; exits nonzero
on any mismatch or fault.  Asked for ``cuda`` without a CUDA device it
raises.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np

# path -> (environment switches, Config fields, probe, search aux mode).
# The sorted-join paths ask for the sorted join, since a small batch
# against a large index would auto-select the search probe; "auto" leaves
# the choice to the engine, as a user's run does.
PATHS = {
    "auto": ({}, {}, None, None),
    "default": ({}, {}, "sort", None),
    "MUSCATO_PJOIN=0": ({"MUSCATO_PJOIN": "0"}, {}, "sort", None),
    "MUSCATO_PEXPAND_SUB=1": ({"MUSCATO_PEXPAND_SUB": "1"}, {}, "sort", None),
    "MUSCATO_PJOIN=0 MUSCATO_PEXPAND_SUB=1":
        ({"MUSCATO_PJOIN": "0", "MUSCATO_PEXPAND_SUB": "1"}, {}, "sort", None),
    "NoDedup": ({}, {"NoDedup": True}, "sort", None),
    "search_direct": ({}, {}, "search", "direct"),
    "search_binary": ({}, {}, "search", "binary"),
}


def canon(mr) -> np.ndarray:
    """The MatchResult's (read_row, gene, start, nmiss) rows, sorted."""
    rows = np.stack([np.asarray(mr.read_row), np.asarray(mr.gene),
                     np.asarray(mr.start), np.asarray(mr.nmiss)], axis=1)
    return rows[np.lexsort((rows[:, 3], rows[:, 2], rows[:, 1], rows[:, 0]))]


@contextlib.contextmanager
def _switched(env: dict):
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _build_aux(index, mode: str):
    """Build ``index``'s search aux in ``mode``: binary is forced by
    allowing no direct bucket table while the aux is built."""
    from ..engine import index as index_mod

    saved = index_mod.MAX_DIRECT_BITS
    if mode == "binary":
        index_mod.MAX_DIRECT_BITS = 0
    try:
        index._aux = None
        return index.search_aux()
    finally:
        index_mod.MAX_DIRECT_BITS = saved


def check_paths(cfg, rs, index, ref_index, paths=tuple(PATHS), log=print,
                ref_cfg=None) -> dict:
    """Run each of ``paths`` on ``index`` and hold its MatchResult to the
    default path's run on ``ref_index`` (the same targets on the CPU) with
    ``ref_cfg`` (default ``cfg``; a MaxPairChunk there changes only how
    the reference chunks its verify).

    Returns {"reference": MatchResult, "reference_s": its seconds,
    "runs": {path: {"ok", "result", "timings", "seconds", "aux",
    "launches", "direct", "error"}}}: "result" and "timings" are the
    path's run on ``index`` (None after a fault), "aux" the search aux a
    search path built on ``index``, "launches" each kernel's launches in
    that run alone (every count of ``pipeline.KERNELS`` is set to 0 just
    before it) and "direct" those of B7 and B10 on their direct route (the
    wrappers' ``direct_launches``, also set to 0).  The index keeps the
    search aux it had before the call."""
    from ..engine import pipeline

    t0 = time.perf_counter()
    ref_mr = pipeline.run_matching_indexed(ref_cfg or cfg, rs, ref_index, probe="sort")
    ref = canon(ref_mr)
    ref_s = time.perf_counter() - t0
    log(f"CPU reference: {len(ref)} retained matches ({ref_s:.2f}s)", flush=True)
    direct = {k: fn for k, fn in pipeline.KERNELS.items() if hasattr(fn, "direct_launches")}
    runs = {}
    saved_aux = index._aux
    try:
        for name in paths:
            env, fields, probe, mode = PATHS[name]
            run = dict(ok=False, result=None, timings=None, aux=None, launches=None,
                       direct=None, error=None)
            t0 = time.perf_counter()
            try:
                if mode is not None:
                    run["aux"] = _build_aux(index, mode)
                tm = {}
                for fn in pipeline.KERNELS.values():
                    fn.launches = 0
                for fn in direct.values():
                    fn.direct_launches = 0
                with _switched(env):
                    mr = pipeline.run_matching_indexed(
                        dataclasses.replace(cfg, **fields), rs, index, probe=probe,
                        timings=tm)
                run.update(result=mr, timings=tm,
                           launches={k: fn.launches for k, fn in pipeline.KERNELS.items()},
                           direct={k: fn.direct_launches for k, fn in direct.items()})
                got = canon(mr)
                run["ok"] = (got.shape == ref.shape and bool(np.array_equal(got, ref))
                             and (mode is None or tm["probe_kind"] == mode))
                if not run["ok"]:
                    log(f"FAIL {name}: {len(got)} rows vs {len(ref)} reference rows "
                        f"(probe {tm['probe_kind']})", flush=True)
            except Exception as e:  # a fault fails its path, loudly
                run["error"] = f"{type(e).__name__}: {e!r:.400}"
                log(f"FAIL {name}: {run['error']}", flush=True)
            run["seconds"] = time.perf_counter() - t0
            runs[name] = run
            log(f"{'PASS' if run['ok'] else 'FAIL'} engine[{name}] "
                f"({run['seconds']:.2f}s)", flush=True)
    finally:
        index._aux = saved_aux
    return {"reference": ref_mr, "reference_s": ref_s, "runs": runs}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--NumRead", type=int, default=500_000)
    p.add_argument("--ReadLen", type=int, default=100)
    p.add_argument("--NumGene", type=int, default=20_000)
    p.add_argument("--GeneLen", type=int, default=1_000)
    p.add_argument("--ReadBatch", type=int, default=0,
                   help="0 = pipeline default; set below NumRead to also "
                        "exercise the multi-batch cap/rank path")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu, where the kernels' plain twins run")
    ns = p.parse_args(argv)

    import torch

    from ..config import Config
    from ..device import resolve_device
    from ..engine.index import build_target_index
    from ..io import native
    from . import gendat

    dev = resolve_device(ns.device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device={dev} kind={kind}", flush=True)
    native.ensure_built()
    cfg = Config(
        Windows=[10, 30, 50, 70], WindowWidth=20, PMatch=0.96,
        MinDinuc=3, MaxReadLength=ns.ReadLen * 2, MMTol=2,
        MaxMatches=10**6, MatchMode="best", ReadBatch=ns.ReadBatch,
    )
    rs, ts = gendat.generate_arrays_realistic(
        ns.NumRead, ns.ReadLen, ns.NumGene, ns.GeneLen, seed=7
    )
    index = build_target_index(ts, cfg.WindowWidth, dev)
    ref_index = build_target_index(ts, cfg.WindowWidth, "cpu")
    out = check_paths(cfg, rs, index, ref_index)
    nref = len(out["reference"].read_row)
    if not nref:
        print("workload produced zero matches: check is vacuous", flush=True)
        return 2
    results = {name: run["ok"] for name, run in out["runs"].items()}
    detail = {
        "device_kind": kind,
        "device": str(dev),
        "num_read": ns.NumRead,
        "reference_matches": nref,
        "results": results,
        "seconds": {name: round(run["seconds"], 3) for name, run in out["runs"].items()},
    }
    print("ENGINE_RESULTS " + json.dumps(results), flush=True)
    print("ENGINE_DETAIL " + json.dumps(detail), flush=True)
    return 0 if all(results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
