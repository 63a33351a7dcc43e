"""The port's batch loop across batches (muscato_tpu_torch.engine.pipeline):
the next batch's upload and probe queued before the loop blocks on the
current batch's total (MUSCATO_PREFETCH_PROBE), the process-wide survivor
capacity hint, the device-batch cache, and the benchmark runner's twin.

Every whole run equals muscato_tpu.engine.pipeline's MatchResult on the
same inputs, on the CPU, exactly.  MaxMatches does not bind here, so the
JAX engine's result does not depend on its batching, and its single-batch
run is the reference for every batching of the port.  A GPU-marked case
holds the card's run with prefetch and the direct probe against the CPU's.
"""

import dataclasses
import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from muscato_tpu import config as jconfig
from muscato_tpu.bench import gendat as jgendat
from muscato_tpu.engine import pipeline as jpipeline
from muscato_tpu_torch import config as tconfig
from muscato_tpu_torch.bench import gendat as tgendat
from muscato_tpu_torch.bench import runner
from muscato_tpu_torch.engine import pipeline as tpipeline
from muscato_tpu_torch.ops import fused, window_queries

_ARGS = (1500, 100, 100, 1000)


@pytest.fixture(scope="module")
def workload():
    return tgendat.generate_arrays_realistic(*_ARGS, seed=5)


@pytest.fixture(scope="module")
def jax_workload():
    return jgendat.generate_arrays_realistic(*_ARGS, seed=5)


def _cfg(**kw):
    base = dict(Windows=[10, 30, 50, 70], WindowWidth=20, PMatch=0.96, MinDinuc=3,
                MaxReadLength=200, MMTol=2, MaxMatches=10**6, MatchMode="best")
    return tconfig.Config(**{**base, **kw})


_JAX_RESULTS = {}


def _jax_result(jax_workload, cfg):
    key = repr(dataclasses.asdict(cfg))
    if key not in _JAX_RESULTS:
        _JAX_RESULTS[key] = jpipeline.run_matching(
            jconfig.Config(**dataclasses.asdict(cfg)), *jax_workload)
    return _JAX_RESULTS[key]


def _assert_same(got, exp):
    assert len(exp.read_row) > 0
    for f in ("read_row", "gene", "start", "nmiss"):
        np.testing.assert_array_equal(getattr(got, f), getattr(exp, f), err_msg=f)


def _trace(monkeypatch):
    """Record the order of the loop's probe and expand calls."""
    calls = []
    for name in ("probe_windows", "expand_verify_dedup"):
        orig = getattr(fused, name)
        monkeypatch.setattr(fused, name, lambda *a, _o=orig, _n=name, **k: (
            calls.append(_n.split("_")[0]), _o(*a, **k))[1])
    return calls


@pytest.mark.parametrize("batch,kind", [(512, "sorted_join"), (256, "direct")])
@pytest.mark.parametrize("prefetch", ["1", "0"], ids=["prefetch", "no-prefetch"])
def test_multibatch_prefetch_matches_jax(workload, jax_workload, monkeypatch,
                                         batch, kind, prefetch):
    """Several batches, on each probe the two packages auto-select, with
    the next probe queued before the current batch's expand (prefetch on)
    or after it (off): the same MatchResult as the JAX engine's."""
    monkeypatch.setenv("MUSCATO_PREFETCH_PROBE", prefetch)
    cfg = _cfg(ReadBatch=batch)
    rs, ts = workload
    index = tpipeline.build_target_index(ts, 20, "cpu")
    calls = _trace(monkeypatch)
    timings = {}
    got = tpipeline.run_matching_indexed(cfg, rs, index, timings=timings)
    _assert_same(got, _jax_result(jax_workload, _cfg()))
    nb = timings["batches"]
    assert nb == -(-rs.num_unique // batch) > 2 and timings["probe_kind"] == kind
    if prefetch == "1":
        assert calls == ["probe", "probe"] + ["expand", "probe"] * (nb - 2) + ["expand"] * 2
    else:
        assert calls == ["probe", "expand"] * nb
    assert set(timings["stages"]) == {"probe", "expand_verify", "rank"}
    assert timings["device_s"] > 0 and timings["fetch_bytes"] > 0


def test_cap_hint_rerun_runs_no_stage_twice(workload, jax_workload, monkeypatch):
    """A streaming run whose survivors overflow the first capacity re-runs
    its stage and keeps the grown capacity in the hint; a second run
    starts there and runs each chunk once, with the same result."""
    monkeypatch.setattr(tpipeline, "_SURV_CAP0", 64)
    monkeypatch.setattr(tpipeline, "_CAP_HINT", [64])
    cfg = _cfg(NoDedup=True, MaxPairChunk=4096)
    rs, ts = workload
    index = tpipeline.build_target_index(ts, 20, "cpu")
    first, second = {}, {}
    got = tpipeline.run_matching_indexed(cfg, rs, index, timings=first)
    one_pass = -(-first["pairs"] // 4096)
    assert first["chunks"] > one_pass
    hint = tpipeline._CAP_HINT[0]
    assert hint > 64
    again = tpipeline.run_matching_indexed(cfg, rs, index, timings=second)
    assert second["chunks"] == one_pass and tpipeline._CAP_HINT[0] == hint
    exp = _jax_result(jax_workload, _cfg())
    _assert_same(got, exp)
    _assert_same(again, exp)


def test_preloaded_batch_is_reused(workload, monkeypatch):
    """preload_device_batch stages a single-batch ReadSet once; the run
    takes the cached arrays and packs nothing."""
    rs, ts = workload
    cfg = _cfg()
    sub = runner._subset(rs, 1, 1000)
    index = tpipeline.build_target_index(ts, 20, "cpu")
    exp = tpipeline.run_matching_indexed(cfg, runner._subset(rs, 1, 1000), index)
    tpipeline.preload_device_batch(cfg, sub, "cpu")
    assert len(sub._dev_cache) == 1
    packs = []
    orig = tpipeline.packed_ops.pack_rows
    monkeypatch.setattr(tpipeline.packed_ops, "pack_rows",
                        lambda c: (packs.append(1), orig(c))[1])
    _assert_same(tpipeline.run_matching_indexed(cfg, sub, index), exp)
    assert not packs


def test_runner_main_prints_one_json_line(monkeypatch):
    monkeypatch.setenv("MUSCATO_BENCH_LOG", "0")
    args = dict(num_read=1500, read_len=100, num_gene=40, gene_len=1000)
    out = io.StringIO()
    with redirect_stdout(out):
        rc = runner.main(["--Workload", "small", "--NumRead", str(args["num_read"]),
                          "--NumGene", str(args["num_gene"]), "--Repeats", "1",
                          "--device", "cpu"])
    assert rc == 0
    lines = out.getvalue().strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert res["metric"] == "reads_per_sec_cpu" and res["unit"] == "reads/s"
    assert res["value"] > 0 and res["vs_baseline"] == round(res["value"] / 1e7, 4)
    d = res["detail"]
    assert d["device"] == "cpu" and d["flags"]["MUSCATO_PREFETCH_PROBE"] is True
    # The runner's last timed repetition: the reads after the first.
    rs, ts = tgendat.generate_arrays(args["num_read"], args["read_len"], args["num_gene"],
                                     args["gene_len"], 0)
    cfg = tconfig.Config(Windows=[10, 30, 50, 70], WindowWidth=20, PMatch=0.96,
                         MinDinuc=3, MaxReadLength=200, MMTol=2, MaxMatches=10**6,
                         MatchMode="best")
    mr = tpipeline.run_matching(cfg, runner._subset(rs, 0, rs.num_unique - 1), ts,
                                device="cpu")
    assert d["small"]["matches"] == len(mr.read_row) > 0


def test_runner_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        runner.main(["--Workload", "small", "--NumRead", "100", "--device", "cuda"])


@pytest.mark.gpu
@pytest.mark.parametrize("prefetch", ["1", "0"], ids=["prefetch", "no-prefetch"])
def test_cuda_search_and_prefetch_match_cpu(workload, monkeypatch, prefetch):
    """On the card: a multi-batch run on the direct probe and one on the
    sorted join, through pinned uploads on a side stream, equal the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setenv("MUSCATO_PREFETCH_PROBE", prefetch)
    rs, ts = workload
    for batch, kind in ((256, "direct"), (512, "sorted_join")):
        cfg = _cfg(ReadBatch=batch)
        before = window_queries.window_queries.launches
        tm = {}
        index = tpipeline.build_target_index(ts, 20, "cuda")
        got = tpipeline.run_matching_indexed(cfg, rs, index, timings=tm)
        assert tm["probe_kind"] == kind
        assert window_queries.window_queries.launches - before == tm["batches"]
        _assert_same(got, tpipeline.run_matching(cfg, rs, ts, device="cpu"))
