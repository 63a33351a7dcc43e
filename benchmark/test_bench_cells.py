"""Cells found by name, and whole runs of a tiny cell on the CPU."""

import io
import json
import os
import re
import time

from benchmark.bench_testing import ROOT, result_line, tiny_copy
from benchmark.harness import cells, runner

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _run(root, bench, cell, trace=False, **kw):
    out, err = io.StringIO(), io.StringIO()
    rc = runner.run(root, cell, 2**31 + 99, 0.5, trace, t_start=time.perf_counter(),
                    device="cpu", bench_dir=bench, out=out, err=err, **kw)
    return rc, result_line(out.getvalue()) if out.getvalue() else None, err.getvalue()


def test_added_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as files,
    with their BENCHMARK.json entries, reach a run with no other change."""
    root, bench, cell = tiny_copy(tmp_path, "docs-w15", "gendat", reads=2000, shift=100)
    with open(os.path.join(bench, "metrics", "calls_in_window.py"), "w") as f:
        f.write("def read(trace):\n    return len(trace['calls'])\n")
    spec_path = os.path.join(root, "BENCHMARK.json")
    with open(spec_path) as f:
        spec = json.load(f)
    spec["per_layer"].append(dict(name="calls_in_window", unit="calls", better="higher",
                                  source="host_clock", layer="entry", moves="reads_per_s",
                                  workloads=[cell]))
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    c = cells.load_cell(root, cell, bench)
    assert c.config["genes"]["count"] == 200 and c.traffic["reads_per_call"] == 2000
    assert c.config["config"]["WindowWidth"] == 15 and c.traffic["planted"] == 10
    assert "calls_in_window" in [m["name"] for m in c.per_layer]
    rc, line, err = _run(root, bench, cell, trace=True)
    assert rc == 0 and line["correct"], err
    assert line["metrics"]["calls_in_window"]["value"] >= 1
    for name in ("upload_ms", "probe_ms", "expand_verify_ms", "rank_ms", "fetch_ms",
                 "assembly_ms"):
        assert line["metrics"][name]["value"] >= 0, name


def test_whole_run_on_the_cpu(tmp_path):
    root, bench, cell = tiny_copy(tmp_path)
    rc, line, err = _run(root, bench, cell)
    assert rc == 0 and line["correct"], err
    assert set(line["metrics"]) == {"reads_per_s", "setup_s"}
    assert line["metrics"]["reads_per_s"]["value"] > 0
    assert list(line)[-1] == "compared"
    assert line["compared"]["reads_differing"] == {"value": 0, "limit": 0}
    assert err.strip().splitlines()[-1] == "compared reads_differing: 0 (limit 0)"
    assert line["window"]["rows_compared"] > 0


def test_benchmark_json_follows_the_contract():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"] and 1 <= spec["run_seconds"] <= 51
    configs = {c["name"]: c for c in spec["configs"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["name"] == f"{w['config']}.{w['traffic']}" and w["config"] in configs
        assert os.path.exists(os.path.join(ROOT, "benchmark", "traffic", w["traffic"] + ".json"))
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert {"setup_s", "reads_per_s"} <= e2e
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    names = [w["name"] for w in spec["workloads"]]
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(names)
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", m["name"] + ".py"))
