"""One run of one cell: set-up, the measured window, the traced calls, the
check against the reference, and the result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the window runs the entry back to back for ``--seconds``
seconds and the line carries the cell's end-to-end metrics: ``setup_s``,
from the start of the process to the first timed call, and
``reads_per_s``, the reads handed to the entry in the window's calls over
the window's whole time (its last call included, which ends past the
deadline).  With ``--trace 1`` every call of the window also fills the
entry's ``timings`` and reads the allocator's peak, then two more calls
run under ``torch.profiler`` (``profiling.py``): one as it is, whose
``busy_s``, ``window_s`` and breakdown the line carries, and one with its
port-kernel launches recorded; the line carries the cell's per-layer
metrics, each from its reader in ``metrics/``.

The window runs with Python's garbage collector off: it collects before
the window and again after it.

Either way the MatchResults of the window's last call and of up to
SAMPLED_CALLS more, drawn from the seed, are held against the plain
reference once the window has closed; ``correct`` says whether every
number compared is within its limit.  ``--control <name>`` puts the
adapter's control in the program's place for that check (it has to come
out not correct).
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time

import numpy as np
import torch

from . import cells, profiling

SAMPLED_CALLS = 2  # calls drawn from the seed, besides the last one, that are checked
TOP = profiling.TOP
FORBIDDEN = ("jax", "jaxlib", "flax", "muscato_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a JAX one or the JAX
    package's, compared whole (``muscato_tpu_torch`` is not
    ``muscato_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class _Kept:
    """The window's last call and a uniform sample of SAMPLED_CALLS of the
    others (a reservoir drawn from the seed), so that at most
    SAMPLED_CALLS + 1 results are held."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng([int(seed), 3])
        self.sample, self.last, self.seen = [], None, 0

    def add(self, item) -> None:
        if self.last is not None:
            prev, self.seen = self.last, self.seen + 1
            if len(self.sample) < SAMPLED_CALLS:
                self.sample.append(prev)
            else:
                j = int(self.rng.integers(0, self.seen))
                if j < SAMPLED_CALLS:
                    self.sample[j] = prev
        self.last = item

    def items(self) -> list:
        return self.sample + ([self.last] if self.last is not None else [])


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(ad, state, seconds: float, device, trace: bool, kept: _Kept) -> dict:
    """Calls of the entry back to back until ``seconds`` have passed.  The
    process's peak device memory is the set-up's or a call's, whichever is
    higher: a traced window resets the allocator's peak before each call."""
    cuda = device.type == "cuda"
    calls, reads = [], 0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    t0 = time.perf_counter()
    while not calls or time.perf_counter() - t0 < seconds:
        tm = {} if trace else None
        if trace and cuda:
            torch.cuda.reset_peak_memory_stats(device)
        c0 = time.perf_counter()
        n, result, offset = ad.call(state, timings=tm)
        c1 = time.perf_counter()
        reads += n
        kept.add((offset, result))
        del result
        calls.append(dict(wall_s=c1 - c0, reads=n, timings=tm,
                          peak_bytes=torch.cuda.max_memory_allocated(device) if trace and cuda
                          else None))
    t1 = time.perf_counter()
    if cuda:
        peak = max([peak, torch.cuda.max_memory_allocated(device)]
                   + [c["peak_bytes"] for c in calls if c["peak_bytes"] is not None])
    return dict(t0=t0, t1=t1, reads=reads, calls=calls, peak=peak)


def _breakdown(profile: dict) -> dict:
    ops = sorted(profile["device_ops"].items(), key=lambda kv: -kv[1])
    gaps = sorted(profile["idle_gaps"], key=lambda g: -g[1])
    return {"device_ops": [[n, s] for n, s in ops[:TOP]],
            "idle_gaps": [[n, s] for n, s in gaps[:TOP]]}


def run(root: str, workload: str, seed: int, seconds: float, trace: bool, *, t_start: float,
        device: str = "cuda", control: str | None = None, bench_dir: str = cells.HERE,
        out=None, err=None) -> int:
    """One run; prints the result line last on ``out``.  Returns the exit
    code."""
    out, err = out or sys.stdout, err or sys.stderr
    cell = cells.load_cell(root, workload, bench_dir)
    device = torch.device(device)
    if device.type == "cuda" and not (torch.cuda.is_available()
                                      and torch.cuda.device_count() >= cell.chips):
        print(f"{workload} needs {cell.chips} CUDA device(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=err, flush=True)
        return 2
    cuda = device.type == "cuda"
    parts = {"imports_s": time.perf_counter() - t_start}
    t = time.perf_counter()
    if cuda:
        torch.empty(1, device=device)
        _sync(device)
    parts["device_init_s"] = time.perf_counter() - t
    ad = cells.adapter(cell)
    state = ad.setup(cell, seed, device)
    parts.update(state.get("setup_parts", {}))
    _sync(device)
    kept = _Kept(seed)
    gc.collect()
    gc.disable()
    try:
        w = window(ad, state, seconds, device, trace, kept)
    finally:
        gc.enable()
    gc.collect()
    setup_s = w["t0"] - t_start
    if trace:
        profile = profiling.profiled_call(lambda: ad.call(state), device)
        kernel_profile = profiling.profiled_call(lambda: ad.call(state), device, kernels=True,
                                                 bench_dir=cell.bench_dir)
    t_check = time.perf_counter()
    compared, counts = ad.compare(state, kept.items(), cell, control)
    check_s = time.perf_counter() - t_check
    del state, kept
    correct = all(v <= lim for v, lim in compared.values())

    found = forbidden_modules()
    if found:
        print(f"modules loaded in the run's process that the benchmark forbids: {found}",
              file=err, flush=True)
        return 3

    elapsed = w["t1"] - w["t0"]
    e2e = {"setup_s": setup_s, "reads_per_s": w["reads"] / elapsed}
    metrics = {}
    if trace:
        record = dict(calls=w["calls"], profile=profile, kernel_profile=kernel_profile)
        for m in cell.per_layer:
            v = cells.metric_reader(cell, m["name"])(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(w["peak"])}
    line = {"correct": correct, "attempted": len(w["calls"]), "failed": 0, "metrics": metrics,
            "device": dev}
    if trace:
        dev["busy_s"] = profile["busy_s"]
        dev["window_s"] = profile["window_s"]
        line["breakdown"] = _breakdown(profile)
    walls = sorted(c["wall_s"] for c in w["calls"])
    line["window"] = {"seconds": elapsed, "calls": len(walls), "reads": w["reads"],
                      "call_s": [walls[0], walls[len(walls) // 2], walls[-1]], "check_s": check_s,
                      **counts, **({"control": control} if control else {})}
    line["setup"] = parts
    line["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    for k, (v, lim) in compared.items():
        print(f"compared {k}: {v} (limit {lim})", file=err, flush=True)
    print(json.dumps(line), file=out, flush=True)
    return 0


def main(argv, t_start: float) -> int:
    import argparse

    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", default=None,
                   help="put this control of the adapter in the program's place for the check")
    a = p.parse_args(argv)
    root = os.path.dirname(cells.HERE)
    return run(root, a.workload, a.seed, a.seconds, bool(a.trace), t_start=t_start,
               control=a.control)
