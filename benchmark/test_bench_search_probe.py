"""The search probe's readers: ``probe_queries_ms``, ``probe_search_ms`` and
``probe_compact_ms`` (the entry's spans ``probe.*``) and
``search_probe_roofline`` (B8's and B9's launches of the recording
profiled call), on synthetic trace records; then whole runs on the CPU of
a tiny copy of ``big-index-w20.mapped-blocked``, through the adapter
``match_blocked`` and the blocked reference."""

import io
import json
import os
import subprocess
import sys
import time

import pytest

from benchmark.bench_testing import ROOT, result_line, tiny_copy
from benchmark.harness import cells, runner

SPANS = {"probe_queries_ms": "probe.queries", "probe_search_ms": "probe.search",
         "probe_compact_ms": "probe.compact"}
NEW_CELLS = ["big-index-w20.mapped-blocked", "bigtest-w20.small-batch"]
CELL = cells.Cell(name="test", chips=1, config={}, traffic={})


def _reader(name):
    return cells.metric_reader(CELL, name)


def _calls(*spans):
    return {"calls": [dict(wall_s=1.0, reads=100, peak_bytes=None,
                           timings={"device_s": 0.5, "spans": sp}) for sp in spans]}


@pytest.mark.parametrize("name", sorted(SPANS))
def test_span_reader(name):
    span = SPANS[name]
    trace = _calls({span: 0.002, "prepare": 1.0}, {span: 0.004}, {"prepare": 1.0})
    assert _reader(name)(trace) == pytest.approx(2.0)  # (2 + 4 + 0) ms over 3 calls
    # A sorted-join call, or a program without these spans (the parent).
    assert _reader(name)(_calls({"prepare": 1.0, "rank.cap": 0.1})) is None
    assert _reader(name)({"calls": [dict(wall_s=1.0, timings=None)]}) is None


def test_search_probe_roofline():
    read = _reader("search_probe_roofline")
    launches = [["binary_probe", 2.0, 0.5], ["sorted_join", 1.0, 1.0],
                ["direct_probe", 2.0, 1.5], ["window_queries", 3.0, 0.1]]
    assert read({"kernel_profile": {"launches": launches}}) == pytest.approx(50.0)
    # No search probe on the card: the sorted join's cells, or the CPU.
    assert read({"kernel_profile": {"launches": launches[1:2] + launches[3:]}}) is None
    assert read({"kernel_profile": {"launches": []}}) is None


def test_the_new_metrics_list_the_new_cells_alone():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = {m["name"]: m for m in json.load(f)["per_layer"]}
    for name in (*SPANS, "search_probe_roofline"):
        assert spec[name]["workloads"] == NEW_CELLS
        assert spec[name]["moves"] == "reads_per_s"
    assert spec["search_probe_roofline"]["source"] == "device_trace"
    for name, m in spec.items():
        if name not in (*SPANS, "search_probe_roofline", "union_ms"):
            assert set(NEW_CELLS) <= set(m["workloads"]), name
    assert not set(NEW_CELLS) & set(spec["union_ms"]["workloads"])


def _tiny_big_index(tmp_path, reads=1000):
    """A copy of the benchmark whose cell ``tiny-bigtest-w20.tiny-mapped-blocked``
    is ``big-index-w20`` cut to 300 genes (294,300 windows, more than 64
    keys a query of a 1,000-read call, so the entry takes the search
    probe), checked by the blocked reference."""
    root, bench, cell = tiny_copy(tmp_path, "bigtest-w20", "mapped-blocked", reads=reads,
                                  shift=100)
    path = os.path.join(bench, "configs", "tiny-bigtest-w20.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["genes"] = {"count": 300, "length": 1000}
    with open(path, "w") as f:
        json.dump(cfg, f)
    return root, bench, cell


@pytest.mark.parametrize("trace,control", [(True, None), (False, "budget-1")],
                         ids=["traced", "control"])
def test_whole_run_of_the_big_index_cell(tmp_path, trace, control):
    root, bench, cell = _tiny_big_index(tmp_path)
    out, err = io.StringIO(), io.StringIO()
    rc = runner.run(root, cell, 2**31 + 77, 0.5, trace, t_start=time.perf_counter(),
                    device="cpu", bench_dir=bench, control=control, out=out, err=err)
    line = result_line(out.getvalue())
    assert rc == 0, err.getvalue()
    assert line["window"]["reference_peak_bytes"] == 0  # no card
    if control:
        assert not line["correct"]
        assert line["compared"]["reads_differing"]["value"] > 0
        return
    assert line["correct"], err.getvalue()
    got = line["metrics"]
    parts = [got[name]["value"] for name in SPANS]
    assert all(v > 0 for v in parts)
    assert sum(parts) <= got["probe_ms"]["value"]
    assert "search_probe_roofline" not in got  # no kernel launches on the CPU


@pytest.mark.parametrize("module,banned", [
    ("benchmark.harness.reference_blocked", (*runner.FORBIDDEN, "muscato_tpu_torch")),
    ("benchmark.adapters.match_blocked", runner.FORBIDDEN)], ids=["reference", "adapter"])
def test_what_the_new_modules_load(module, banned):
    """The blocked reference loads nothing of either package, its adapter
    nothing of JAX or of the JAX package."""
    code = (f"import json, sys\nimport {module}\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert not set(json.loads(out.stdout.strip().splitlines()[-1])) & set(banned)
