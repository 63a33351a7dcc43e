"""Profile one match of N million flagship reads against the 100M-base
index (twin of ``muscato_tpu/bench/profile_match.py``).

After a warm run, ``torch.profiler`` traces one ``run_matching_indexed``
of the reads shifted by one (a new ReadSet, whose device copy the warm
run did not cache), staged on the device beforehand.  Prints the
traced run's time and match count, the top 25 device kernels by self time
with their launch counts (on the CPU: the top 25 operators by self CPU
time), and each stage span's time (``timings["stages"]``: CUDA events on
a card).

    python -m muscato_tpu_torch.bench.profile_match [reads_millions]
        [--device cuda|cpu] [--NumGene N]

Asked for ``cuda`` without a CUDA device it raises.
"""

from __future__ import annotations

import argparse
import json
import time


def device_events(prof) -> list:
    """The profile's device events (kernels and copies on the card),
    sorted by start."""
    from torch.autograd import DeviceType

    return sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)


def short_name(name: str) -> str:
    """A kernel's name without its namespace and argument list."""
    return name.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")[:120]


def kernel_table(events, key=short_name) -> dict:
    """{key(event name): [launches, ms]} of device ``events``, by self time
    (device kernels have no children), largest first."""
    by_name = {}
    for e in events:
        t = by_name.setdefault(key(e.name), [0, 0.0])
        t[0] += 1
        t[1] += (e.time_range.end - e.time_range.start) / 1e3
    return dict(sorted(by_name.items(), key=lambda kv: -kv[1][1]))


def profile(cfg, rs, index, device, top: int = 25) -> dict:
    """A warm run of ``rs``, then one profiled run of its reads shifted by
    one (staged on the device first) against ``index``.  Returns the traced
    run's seconds and matches, ``kernels`` ({name: {launches, ms}}, the
    top ``top`` by self time: device kernels on a card, operators on the
    CPU), the total, and ``stages`` (seconds per stage span)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from ..engine import pipeline
    from .runner import _subset

    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    pipeline.run_matching_indexed(cfg, rs, index)
    sub = _subset(rs, 1, rs.num_unique - 2)
    pipeline.preload_device_batch(cfg, sub, device)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    tm = {}
    sync()
    with torch_profile(activities=acts) as prof:
        t0 = time.perf_counter()
        mr = pipeline.run_matching_indexed(cfg, sub, index, timings=tm)
        sync()
        dt = time.perf_counter() - t0
    if cuda:
        table = kernel_table(device_events(prof))
        if not table:
            raise RuntimeError("profile_match: the profiler recorded no device time")
    else:
        table = {a.key: [a.count, a.self_cpu_time_total / 1e3] for a in sorted(
            prof.key_averages(), key=lambda a: -a.self_cpu_time_total)}
    return dict(
        traced_s=dt, matches=len(mr.read_row), source="device kernels" if cuda else "cpu ops",
        total_ms=sum(ms for _, ms in table.values()),
        kernels={k: {"launches": c, "ms": ms} for k, (c, ms) in list(table.items())[:top]},
        stages=tm["stages"],
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("reads_millions", nargs="?", type=float, default=4.0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu, where the wrappers run their twins")
    p.add_argument("--NumGene", type=int, default=100_000)
    ns = p.parse_args(argv)

    from ..config import Config
    from ..device import resolve_device
    from ..engine.index import build_target_index
    from ..io import native
    from . import gendat

    dev = resolve_device(ns.device)
    native.ensure_built()
    num_read = int(ns.reads_millions * 1e6)
    cfg = Config(
        Windows=[10, 30, 50, 70], WindowWidth=20, PMatch=0.96,
        MinDinuc=3, MaxReadLength=200, MMTol=2,
        MaxMatches=10**6, MatchMode="best", ReadBatch=1 << 23,
    )
    print("generating workload...", flush=True)
    rs, ts = gendat.generate_arrays_realistic(num_read, 100, ns.NumGene, 1000, 0)
    index = build_target_index(ts, cfg.WindowWidth, dev)
    print("index built", flush=True)
    out = profile(cfg, rs, index, dev)
    print(f"traced run: {out['traced_s']:.3f}s, {out['matches']} matches", flush=True)
    print(f"{out['source']}: total {out['total_ms']:.3f} ms", flush=True)
    for name, k in out["kernels"].items():
        print(f"  {k['ms']:10.3f} ms  {k['launches']:6d}x  {name}", flush=True)
    print("stage spans (s): " + json.dumps(out["stages"]), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
