"""Finding a cell's parts by name.

``BENCHMARK.json`` at the checkout's root names each cell as
``<config>.<traffic>``; the harness finds the rest by those names alone:

  configs/<config>.json    the configuration: its source, the engine's
                           flags, the gene set, the read length
  traffic/<traffic>.json   the traffic mix: its entry adapter and its
                           parameters
  adapters/<adapter>.py    the entry the window drives (setup, call,
                           check)
  metrics/<metric>.py      a per-layer metric's reader (``read(trace)``)
  kernels/<kernel>.py      a port kernel of ``pipeline.KERNELS``: its CUDA
                           symbol (``SYMBOL``) and its work
                           (``call_work(args, kw)``)

so that a later change adds a cell, a mix, a metric or a kernel by adding
files and entries, without editing a file that is there.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # benchmark/


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)  # this cell's end-to-end metric entries
    per_layer: list = field(default_factory=list)  # this cell's per-layer metric entries
    bench_dir: str = HERE


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: str, workload: str, bench_dir: str = HERE) -> Cell:
    """The cell ``workload`` of ``root``/BENCHMARK.json with its
    configuration and traffic files read from ``bench_dir``."""
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=load_json(os.path.join(bench_dir, "configs", w["config"] + ".json")),
        traffic=load_json(os.path.join(bench_dir, "traffic", w["traffic"] + ".json")),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, workload)],
        bench_dir=bench_dir,
    )


def _load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def adapter(cell: Cell):
    """The entry adapter that the cell's traffic names."""
    name = cell.traffic["adapter"]
    return _load_module(os.path.join(cell.bench_dir, "adapters", name + ".py"),
                        "bench_adapter_" + name)


def metric_reader(cell: Cell, name: str):
    """The ``read(trace)`` function of per-layer metric ``name``."""
    return _load_module(os.path.join(cell.bench_dir, "metrics", name + ".py"),
                        "bench_metric_" + name.replace(".", "_").replace("-", "_")).read


def kernel_spec(bench_dir: str, name: str):
    """The module of port kernel ``name`` (``SYMBOL``, ``call_work``)."""
    return _load_module(os.path.join(bench_dir, "kernels", name + ".py"), "bench_kernel_" + name)
