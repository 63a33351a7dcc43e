"""Helpers of the benchmark's CPU tests: a copy of the benchmark with tiny
cells of its own, found by name as any cell is."""

from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TINY_GENES = {"bigtest-w20": {"count": 200, "length": 1000},
              "docs-w15": {"count": 200, "length": 400}}


def tiny_copy(tmp, config: str = "bigtest-w20", traffic: str = "mapped", reads: int = 4000,
              shift: int = 200) -> tuple:
    """(root, bench_dir, cell) of a copy of the benchmark under ``tmp``
    with one more cell, ``tiny-<config>.tiny-<traffic>``: the
    configuration with a small gene set and the mix with ``reads`` reads a
    call, each a file of its own, and listed by every per-layer metric."""
    root = os.path.join(str(tmp), "checkout")
    bench = os.path.join(root, "benchmark")
    if not os.path.exists(bench):
        shutil.copytree(HERE, bench, ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    with open(os.path.join(bench, "configs", config + ".json")) as f:
        cfg = json.load(f)
    cfg["genes"], cfg["reduced"] = TINY_GENES[config], ["genes"]
    with open(os.path.join(bench, "traffic", traffic + ".json")) as f:
        mix = json.load(f)
    mix.update(reads_per_call=reads, shift_span=shift)
    names = ("tiny-" + config, "tiny-" + traffic)
    for sub, name, body in (("configs", names[0], cfg), ("traffic", names[1], mix)):
        with open(os.path.join(bench, sub, name + ".json"), "w") as f:
            json.dump(body, f)
    cell = ".".join(names)
    spec_path = os.path.join(root, "BENCHMARK.json")
    with open(spec_path) as f:
        spec = json.load(f)
    if cell not in {w["name"] for w in spec["workloads"]}:
        spec["workloads"].append(dict(name=cell, config=names[0], traffic=names[1], chips=1,
                                      why="a test cell"))
        for m in spec["per_layer"]:
            m.setdefault("workloads", []).append(cell)
        with open(spec_path, "w") as f:
            json.dump(spec, f)
    return root, bench, cell


def result_line(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])
