"""The readers of the entry's own spans and counters (``harness/spans.py``
and its metrics), on synthetic trace records, and a whole traced run on
the CPU of a tiny copy of ``bigtest-w20-rb1m``, whose calls run several
batches and their union."""

import io
import json
import os
import time

import pytest

from benchmark.bench_testing import TINY_GENES, result_line, tiny_copy
from benchmark.harness import cells, runner

# Each new reader with the spans it sums.
SPAN_METRICS = {
    "prepare_ms": ("prepare",), "upload_stage_ms": ("upload.stage",),
    "h2d_ms": ("upload.h2d",), "read_pack_ms": ("read_pack",),
    "host_wait_ms": ("wait.upload", "wait.total", "wait.survivors", "wait.count"),
    "rank_cap_ms": ("rank.cap",), "rank_dedup_ms": ("rank.dedup",),
    "d2h_ms": ("fetch.d2h",), "unpack_ms": ("fetch.unpack",), "assemble_ms": ("assemble",),
    "union_ms": ("union.cap", "union.rank"),
}
COUNT_METRICS = ("pairs_per_read", "verify_yield", "rows_per_read")
CELL = cells.Cell(name="test", chips=1, config={}, traffic={})


def _reader(name):
    return cells.metric_reader(CELL, name)


def _calls(*spans, counts=None, pairs=0):
    return {"calls": [dict(wall_s=1.0, reads=100, peak_bytes=None,
                           timings={"device_s": 0.5, "fetch_s": 0.1, "pairs": pairs,
                                    "spans": sp, **({"counts": counts} if counts else {})})
                      for sp in spans]}


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_span_reader_gives_the_mean_per_call(name):
    names = SPAN_METRICS[name]
    one = {n: 0.001 * (k + 1) for k, n in enumerate(names)}
    two = {n: 0.003 for n in names}
    trace = _calls(one, two, {"other": 1.0})  # the third call has none of them: 0
    want = 1e3 * (sum(one.values()) + sum(two.values())) / 3
    assert _reader(name)(trace) == pytest.approx(want)
    assert _reader(name)(_calls({"other": 1.0}, {})) is None
    # A program without spans (the parent of this reader), or no timings.
    parent = {"calls": [dict(wall_s=1.0, reads=1, peak_bytes=None, timings={"device_s": 0.5})]}
    assert _reader(name)(parent) is None
    assert _reader(name)({"calls": [dict(wall_s=1.0, timings=None)]}) is None


def test_count_readers():
    trace = _calls({}, {}, counts=dict(reads=1000, survivors=30, retained=20), pairs=400)
    assert _reader("pairs_per_read")(trace) == pytest.approx(0.4)
    assert _reader("verify_yield")(trace) == pytest.approx(7.5)
    assert _reader("rows_per_read")(trace) == pytest.approx(0.02)
    for name in COUNT_METRICS:
        assert _reader(name)(_calls({}, {})) is None  # no counts
    assert _reader("verify_yield")(_calls({}, counts=dict(reads=5, survivors=0,
                                                           retained=0))) is None  # no pairs


def test_every_new_metric_is_in_benchmark_json():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = {m["name"]: m for m in json.load(f)["per_layer"]}
    for name in (*SPAN_METRICS, *COUNT_METRICS):
        assert spec[name]["moves"] == "reads_per_s"
        assert spec[name]["source"] == ("program_counter" if name in COUNT_METRICS
                                        else "program_span")
    assert spec["union_ms"]["workloads"] == ["bigtest-w20-rb1m.mapped"]
    assert "bigtest-w20-rb1m.mapped" not in spec["unpack_ms"]["workloads"]


def _tiny_rb1m(tmp_path, reads=4000, batch=1024):
    """A copy of the benchmark with the cell ``tiny-bigtest-w20-rb1m.tiny-mapped``:
    ``bigtest-w20-rb1m`` on the tiny genes, its ReadBatch cut so that a
    call of ``reads`` reads runs several batches."""
    root, bench, _ = tiny_copy(tmp_path, reads=reads)
    with open(os.path.join(bench, "configs", "bigtest-w20-rb1m.json")) as f:
        cfg = json.load(f)
    cfg["genes"], cfg["reduced"] = TINY_GENES["bigtest-w20"], ["genes", "ReadBatch"]
    cfg["config"]["ReadBatch"] = batch
    with open(os.path.join(bench, "configs", "tiny-bigtest-w20-rb1m.json"), "w") as f:
        json.dump(cfg, f)
    cell = "tiny-bigtest-w20-rb1m.tiny-mapped"
    spec_path = os.path.join(root, "BENCHMARK.json")
    with open(spec_path) as f:
        spec = json.load(f)
    spec["workloads"].append(dict(name=cell, config="tiny-bigtest-w20-rb1m",
                                  traffic="tiny-mapped", chips=1, why="a test cell"))
    for m in spec["per_layer"]:
        if m["name"] != "unpack_ms":
            m["workloads"].append(cell)
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    return root, bench, cell


def test_whole_traced_run_of_the_union_cell(tmp_path):
    root, bench, cell = _tiny_rb1m(tmp_path)
    out, err = io.StringIO(), io.StringIO()
    rc = runner.run(root, cell, 2**31 + 99, 0.5, True, t_start=time.perf_counter(),
                    device="cpu", bench_dir=bench, out=out, err=err)
    line = result_line(out.getvalue())
    assert rc == 0 and line["correct"], err.getvalue()
    got = line["metrics"]
    assert got["union_ms"]["value"] > 0 and got["union_ms"]["unit"] == "ms"
    for name in ("prepare_ms", "upload_stage_ms", "read_pack_ms", "host_wait_ms",
                 "rank_cap_ms", "rank_dedup_ms", "d2h_ms", "assemble_ms"):
        assert got[name]["value"] >= 0, name
    assert "h2d_ms" not in got  # the CPU uploads nothing
    assert "unpack_ms" not in got
    assert got["pairs_per_read"]["value"] > 0 and 0 < got["verify_yield"]["value"] <= 100
    assert got["rows_per_read"]["value"] > 0
    # The accepted metrics of the entry's timings read there too.
    for name in ("upload_ms", "probe_ms", "expand_verify_ms", "rank_ms", "fetch_ms",
                 "assembly_ms"):
        assert got[name]["value"] >= 0, name
