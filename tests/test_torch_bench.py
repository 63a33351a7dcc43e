"""The port's bench tools (muscato_tpu_torch/bench/: the twins of the JAX
package's scaling, engine_device_check, pallas_device_check,
profile_match, micro_verify, bigtest and prep_rss), each run at a tiny
size with ``--device cpu`` (prep_rss, which runs on the host only, takes
no ``--device``), where every kernel wrapper runs its plain twin: the
keys each prints, and engine_device_check and pallas_device_check report
every path and kernel equal.  Each tool that takes ``--device`` raises
when asked for ``cuda`` on a machine without a card.
"""

import importlib
import json
import os
import socket
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The tools that take --device (prep_rss runs on the host only).
DEVICE_TOOLS = ("scaling", "engine_device_check", "pallas_device_check", "profile_match",
                "micro_verify", "bigtest")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the suite runs several workers on the
    host's cores, where small tensor ops on many threads wait on each
    other (micro_verify's CPU run slowed over a hundredfold on 8 threads
    beside 8 busy processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _main(name):
    return importlib.import_module(f"muscato_tpu_torch.bench.{name}").main


def _json_after(out: str, tag: str) -> dict:
    (line,) = [ln for ln in out.splitlines() if ln.startswith(tag + " ")]
    return json.loads(line[len(tag) + 1:])


def test_engine_device_check_all_paths_equal(capsys):
    from muscato_tpu_torch.bench import engine_device_check as edc

    rc = edc.main(["--NumRead", "1500", "--NumGene", "150", "--device", "cpu"])
    out = capsys.readouterr().out
    results = _json_after(out, "ENGINE_RESULTS")
    assert rc == 0 and results == {p: True for p in edc.PATHS}
    detail = _json_after(out, "ENGINE_DETAIL")
    assert detail["reference_matches"] > 0 and detail["device"] == "cpu"
    assert set(detail["seconds"]) == set(edc.PATHS)


def test_engine_device_check_reports_a_wrong_path(monkeypatch):
    """A fault in one path fails that path alone; a path whose
    MatchResult differs from the reference fails."""
    from muscato_tpu_torch.bench import engine_device_check as edc
    from muscato_tpu_torch.bench import gendat
    from muscato_tpu_torch.config import Config
    from muscato_tpu_torch.engine import index as tindex
    from muscato_tpu_torch.engine import pipeline
    from muscato_tpu_torch.ops import fused

    cfg = Config(Windows=[10, 30, 50, 70], WindowWidth=20, PMatch=0.96, MinDinuc=3,
                 MaxReadLength=200, MMTol=2, MaxMatches=10**6, MatchMode="best")
    rs, ts = gendat.generate_arrays_realistic(1500, 100, 100, 1000, seed=3)
    index = tindex.build_target_index(ts, 20, "cpu")

    def fault(*args, **kw):
        raise RuntimeError("injected fault")

    quiet = lambda *a, **k: None  # noqa: E731
    with monkeypatch.context() as m:
        m.setattr(fused, "expand_verify_streamed", fault)
        out = edc.check_paths(cfg, rs, index, index, paths=("default", "NoDedup"), log=quiet)
    runs = out["runs"]
    assert runs["default"]["ok"] and not runs["NoDedup"]["ok"]
    assert "injected fault" in runs["NoDedup"]["error"]
    other = tindex.build_target_index(pipeline.gene_range(ts, 0, 50), 20, "cpu")
    out = edc.check_paths(cfg, rs, index, other, paths=("default",), log=quiet)
    assert not out["runs"]["default"]["ok"] and out["runs"]["default"]["error"] is None


def test_pallas_device_check_every_kernel(capsys):
    rc = _main("pallas_device_check")(["--device", "cpu", "--Shapes", "small"])
    out = capsys.readouterr().out
    results = _json_after(out, "PALLAS_RESULTS")
    assert rc == 0 and results == {f"{k} small": True for k in (
        "monotone_gather", "monotone_gather_rows", "sorted_join", "window_queries",
        "expand_owners", "expand_owners_sub")}
    assert "OK: 0 failed" in out


def test_micro_verify_modes(capsys):
    rc = _main("micro_verify")(["0.004", "--device", "cpu", "--Bases", "100000",
                                "--Reads", "3000"])
    out = capsys.readouterr().out
    assert rc == 0 and "tables ready" in out
    for label, unit in (("full", "lane"), ("const_read", "lane"), ("const_diag", "lane"),
                        ("tuned read=full", "lane"), ("tuned read=const_read", "lane"),
                        *((f"tuned read={m} SWAR body, {f}", "lane")
                          for m in ("full", "const_read")
                          for f in ("verify_diagonals_swar", "verify_diagonals_swar_torch")),
                        ("read-row gather alone (index_select)", "row"),
                        ("sort + B4 row ride", "row")):
        assert any(ln.startswith(label + ": ") and ln.endswith(f" ns/{unit}")
                   for ln in out.splitlines()), label


def test_profile_match_report(capsys):
    rc = _main("profile_match")(["0.002", "--NumGene", "100", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0
    (traced,) = [ln for ln in out if ln.startswith("traced run: ")]
    assert traced.endswith(" matches") and int(traced.split(", ")[1].split()[0]) > 0
    assert any(ln.startswith("cpu ops: total ") for ln in out)
    (spans,) = [ln for ln in out if ln.startswith("stage spans (s): ")]
    assert set(json.loads(spans.split(": ", 1)[1])) == {"probe", "expand_verify", "rank"}
    assert sum(ln.startswith("  ") and "x  " in ln for ln in out) == 25


def test_bigtest_runs_the_driver(tmp_path, capsys):
    rc = _main("bigtest")(["--NumRead", "1500", "--NumGene", "200",
                           "--Dir", str(tmp_path / "bt"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "gendat: " in out and "prep_targets: " in out
    (line,) = [ln for ln in out.splitlines() if ln.startswith("full run: ")]
    rows = int(line.split(", ")[-1].split()[0])
    with open(tmp_path / "bt" / "results.txt", "rb") as f:
        assert rows == sum(1 for _ in f) > 0
    assert "muscato.index: built index" in out  # the run's logs, echoed


def test_prep_rss_modes_identical(tmp_path, capsys):
    rc = _main("prep_rss")(["--NumRead", "3000", "--Chunk", "700",
                            "--Dir", str(tmp_path / "pr")])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert rc == 0 and [r.get("mode") for r in lines[:2]] == ["chunked", "full"]
    for r in lines[:2]:
        assert {"seconds", "peak_anon_mb", "peak_rss_mb", "unique", "total",
                "digest"} <= set(r) and r["total"] == 3000
    assert lines[2]["identical"] is True and "anon_ratio" in lines[2]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_scaling_world_of_one(capsys):
    """Started alone: a world of one process (gloo on the CPU), one 1x1 line."""
    rc = _main("scaling")(["--NumRead", "500", "--NumGene", "40", "--Repeats", "1",
                           "--device", "cpu"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert rc == 0 and [(r["mesh"], r["devices"]) for r in lines] == [("1x1", 1)]
    assert lines[0]["reads_per_sec"] > 0


def test_scaling_two_process_gloo_world():
    """Two processes with --Coordinator: rank 0 prints the 1x2 and the 2x1
    mesh, rank 1 prints nothing."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, (ROOT, os.environ.get("PYTHONPATH")))))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "muscato_tpu_torch.bench.scaling", "--device", "cpu",
         "--NumRead", "400", "--NumGene", "30", "--Repeats", "1",
         "--Coordinator", f"localhost:{port}", "--ProcessCount", "2",
         "--ProcessIndex", str(i)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env) for i in range(2)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    rows = [json.loads(ln) for ln in outs[0][0].splitlines() if ln.startswith("{")]
    assert [(r["mesh"], r["devices"]) for r in rows] == [("1x2", 2), ("2x1", 2)]
    assert all(set(r) == {"mesh", "devices", "reads_per_sec"} for r in rows)
    assert not [ln for ln in outs[1][0].splitlines() if ln.startswith("{")]


@pytest.mark.parametrize("name", DEVICE_TOOLS)
def test_tool_asked_for_cuda_without_a_card_raises(name, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        _main(name)([])
    assert not os.listdir(tmp_path)  # it raised before it wrote anything
