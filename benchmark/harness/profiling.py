"""Profiled calls of the entry: ``torch.profiler`` around one whole call,
reduced to what the per-layer readers take: the call's span, the
device's busy time in it, its idle gaps labelled by the host operation
open in each, and the device operations by name; and, in a call whose
port-kernel calls are recorded, each launch of a port kernel with its
device time and its bound (from the launch's own inputs).  Recording
keeps every launch's inputs alive to the end of the call, which makes the
allocator grow, so the busy share is read from a call that records
nothing.

The port's kernels are the wrappers of ``pipeline.KERNELS``, each with
its launch counter.  Every module attribute of the port that holds one
is wrapped for the call, so that each call of a wrapper is recorded with
its inputs, under the kernels whose counters it moved itself (a nested
wrapper's launches are its own).  Each kernel has a file of its own,
``kernels/<name>.py``, which gives its CUDA symbol as a profile names it
(``SYMBOL``) and its work (``call_work(args, kw)``, from ``work.py``).
The traced run fails, rather than leave a launch out of the roofline,
where a kernel of ``pipeline.KERNELS`` has no such file, where a launch
was made by no wrapped call, or where the profile's launches of a kernel
disagree in number with the recorded ones in each of TRIES calls (the
profiler has been seen to miss one).
"""

from __future__ import annotations

import contextlib
import os
import re
import sys

import torch

from . import cells, work

TRIES = 3
TOP = 10  # device operations and idle gaps kept for the breakdown
CALL_SPAN = "bench.call"


def kernel_specs(bench_dir: str = cells.HERE) -> dict:
    """{name: module} of each kernel of ``pipeline.KERNELS``, from
    ``kernels/<name>.py``; raises for a kernel that has none."""
    from muscato_tpu_torch.engine import pipeline

    missing = [k for k in pipeline.KERNELS
               if not os.path.exists(os.path.join(bench_dir, "kernels", k + ".py"))]
    if missing:
        raise RuntimeError(f"port kernels with no kernels/<name>.py (symbol and work) in the "
                           f"benchmark: {missing}")
    return {k: cells.kernel_spec(bench_dir, k) for k in pipeline.KERNELS}


def _plain_name(name: str, kw: dict) -> str:
    """The kernel a wrapper's call stands for where it runs its twin."""
    return name + "_sub" if name == "expand_owners" and kw.get("subchunk") else name


@contextlib.contextmanager
def recorded_calls(plain: bool = False):
    """Wrap each port module attribute that holds a wrapper of
    ``pipeline.KERNELS`` for a block.  Each call that launches a kernel
    itself appends {kernel, launches, args, kw} to the yielded list.  The
    hook calls the wrappers themselves, so their launch counts move as
    without it.  With ``plain`` (CPU tensors, where the wrappers run their
    twins and launch nothing) every call is recorded under its wrapper's
    kernel.  Raises, once the block is done, for launches that no
    wrapped call made."""
    from muscato_tpu_torch.engine import pipeline

    counters = pipeline.KERNELS
    by_id = {id(fn): k for k, fn in counters.items()}
    calls, saved, stack = [], [], []

    class hook:
        """A wrapper's stand-in: its attributes (the launch counters that
        the wrapper moves through its own global name) are the
        wrapper's."""

        def __init__(self, orig, name):
            object.__setattr__(self, "orig", orig)
            object.__setattr__(self, "name", name)

        def __getattr__(self, attr):
            return getattr(self.orig, attr)

        def __setattr__(self, attr, value):
            setattr(self.orig, attr, value)

        def __call__(self, *args, **kw):
            before = {k: fn.launches for k, fn in counters.items()}
            stack.append(dict.fromkeys(counters, 0))
            try:
                res = self.orig(*args, **kw)
            finally:
                nested = stack.pop()
            moved = {k: fn.launches - before[k] for k, fn in counters.items()}
            if stack:
                for k, n in moved.items():
                    stack[-1][k] += n
            if plain:
                calls.append(dict(kernel=_plain_name(self.name, kw), launches=0, args=args,
                                  kw=kw))
            calls.extend(dict(kernel=k, launches=n - nested[k], args=args, kw=kw)
                         for k, n in moved.items() if n - nested[k])
            return res

    mods = [m for n, m in list(sys.modules.items())
            if m is not None and (n == "muscato_tpu_torch" or n.startswith("muscato_tpu_torch."))]
    for mod in mods:
        for attr, val in list(vars(mod).items()):
            name = by_id.get(id(val))
            if name is not None:
                saved.append((mod, attr, val))
                setattr(mod, attr, hook(val, name))
    start = {k: fn.launches for k, fn in counters.items()}
    try:
        yield calls
    finally:
        for mod, attr, orig in reversed(saved):
            setattr(mod, attr, orig)
    made = {k: fn.launches - start[k] for k, fn in counters.items()}
    seen = dict.fromkeys(counters, 0)
    for c in calls:
        seen[c["kernel"]] = seen.get(c["kernel"], 0) + c["launches"]
    lost = {k: [n, seen[k]] for k, n in made.items() if n != seen[k]}
    if lost:
        raise RuntimeError(f"port-kernel launches that no wrapped call made (kernel: [launches, "
                           f"recorded]): {lost}")


def short_name(name: str) -> str:
    """A kernel's name without its namespace and argument list."""
    return name.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")[:120]


def _union(intervals, lo: float, hi: float):
    """The disjoint, sorted pieces of the union of ``intervals`` within
    [lo, hi]."""
    out = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _reduce(prof, calls, patterns: dict) -> dict:
    """The profile of one call reduced (times in seconds)."""
    from torch.autograd import DeviceType

    evs = prof.events()
    span = next(e for e in evs if e.name == CALL_SPAN and e.device_type == DeviceType.CPU)
    lo, hi = span.time_range.start, span.time_range.end
    # The device's kernels, copies and sets (the call's own annotation,
    # which the profiler also lays on the device's timeline, left out).
    dev = sorted((e for e in evs if e.device_type == DeviceType.CUDA and e.name != CALL_SPAN),
                 key=lambda e: e.time_range.start)
    busy = _union([(e.time_range.start, e.time_range.end) for e in dev], lo, hi)
    host = [e for e in evs if e.device_type == DeviceType.CPU and e.name != CALL_SPAN
            and e.time_range.start >= lo and e.time_range.end <= hi]
    gaps, edge = [], lo
    for a, b in busy + [[hi, hi]]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    labelled = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]:
        mid = (a + b) / 2
        open_ = [e for e in host if e.time_range.start <= mid <= e.time_range.end]
        name = (max(open_, key=lambda e: e.time_range.start).name if open_
                else "host, no torch operation open")
        labelled.append((name, (b - a) / 1e6))
    ops = {}
    for e in dev:
        n = short_name(e.name)
        ops[n] = ops.get(n, 0.0) + (e.time_range.end - e.time_range.start) / 1e6
    per_kernel = {k: [(e.time_range.end - e.time_range.start) / 1e3 for e in dev
                      if p.search(e.name)] for k, p in patterns.items()}
    hooked = {k: [c for c in calls if c["kernel"] == k] for k in patterns}
    counts = {k: [len(per_kernel[k]), sum(c["launches"] for c in hooked[k])] for k in patterns}
    return dict(window_s=(hi - lo) / 1e6, busy_s=sum(b - a for a, b in busy) / 1e6,
                idle_gaps=labelled, device_ops=ops, agree=all(a == b for a, b in counts.values()),
                counts=counts, per_kernel=per_kernel, hooked=hooked)


def profiled_call(fn, device, kernels: bool = False, bench_dir: str = cells.HERE) -> dict:
    """One call ``fn()`` under torch.profiler, reduced.  With ``kernels``
    its port-kernel calls are recorded too, the call retaken while its
    launches disagree with the recorded ones, and ``launches`` holds each
    recorded call's [kernel, ms over its launches, bound_ms]; raises if
    no try of TRIES agrees."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    specs = kernel_specs(bench_dir) if kernels else {}
    patterns = {k: re.compile(r"(?<![\w])" + m.SYMBOL + r"\b") for k, m in specs.items()}
    record = recorded_calls if kernels else contextlib.nullcontext
    for attempt in range(1, (TRIES if kernels else 1) + 1):
        if cuda:
            torch.cuda.synchronize(device)
        with record() as calls, profile(activities=acts) as prof:
            with record_function(CALL_SPAN):
                fn()
            if cuda:
                torch.cuda.synchronize(device)
        out = _reduce(prof, calls or [], patterns)
        del prof
        if not kernels:
            for key in ("per_kernel", "hooked", "agree", "counts"):
                out.pop(key)
            return out
        if out["agree"]:
            break
        print(f"profiled call {attempt}: the profile's launches disagree with the recorded "
              f"ones (kernel: [profile, recorded]) {out['counts']}", file=sys.stderr, flush=True)
    else:
        raise RuntimeError(f"the profile's port-kernel launches disagreed with the recorded ones "
                           f"in all {TRIES} profiled calls: {out['counts']}")
    per_kernel, hooked = out.pop("per_kernel"), out.pop("hooked")
    out["tries"] = attempt
    out["launches"] = []
    for k, spec in specs.items():
        times = iter(per_kernel[k])
        for c in hooked[k]:
            ms = sum(next(times) for _ in range(c["launches"]))
            out["launches"].append(
                [k, ms, work.bounds(spec.call_work(c["args"], c["kw"]))["bound_ms"]])
    del calls, hooked
    return out
