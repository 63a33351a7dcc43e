"""The spans and counters of the port's entry (``pipeline.run_matching_indexed``):
``timings["spans"]`` and ``timings["counts"]``, the profiler ranges of its
host spans, and a call with tracing off, which records no CUDA event and
opens no range.  On the CPU workload of ``test_torch_pipeline.py``, made
by the port's gendat alone."""

import time

import numpy as np
import pytest
import torch

from muscato_tpu_torch import config as tconfig
from muscato_tpu_torch.bench import gendat as tgendat
from muscato_tpu_torch.engine import pipeline as tpipeline
from muscato_tpu_torch.io.reads import ReadSet
from muscato_tpu_torch.ops import fused

_ARGS = (5000, 100, 200, 1000)
# Host and device spans of every call that retains rows; the packed fetch
# adds its unpack, several batches their union on the device.
_ALWAYS = {"prepare", "upload.stage", "read_pack", "wait.total", "wait.survivors",
           "wait.count", "rank.cap", "rank.dedup", "fetch.d2h", "assemble"}
_DEVICE = ("probe", "expand_verify", "rank", "rank.cap", "rank.dedup", "upload.h2d",
           "read_pack", "union.cap", "union.rank")
_BLOCKING = ("wait.survivors", "wait.count", "fetch.d2h")


@pytest.fixture(scope="module")
def workload():
    rs, ts = tgendat.generate_arrays_realistic(*_ARGS, seed=1)
    return rs, tpipeline.build_target_index(ts, 20, "cpu")


def _cfg(batch=0):
    return tconfig.Config(Windows=[10, 30, 50, 70], WindowWidth=20, PMatch=0.96, MinDinuc=3,
                          MaxReadLength=200, MMTol=2, MaxMatches=10**6, MatchMode="best",
                          ReadBatch=batch)


_CASES = {"w20": _cfg(), "w20-multibatch": _cfg(2048)}  # one batch; three batches


def _fresh(rs):
    """``rs``'s reads as a ReadSet of their own, whose upload no earlier
    call has cached."""
    return ReadSet(codes=rs.codes, lengths=rs.lengths, counts=rs.counts,
                   num_total=rs.num_total)


def _timed(workload, cfg):
    rs, index = workload
    rs = _fresh(rs)
    timings = {}
    t0 = time.perf_counter()
    mr = tpipeline.run_matching_indexed(cfg, rs, index, timings=timings)
    return mr, timings, time.perf_counter() - t0


@pytest.mark.parametrize("case", list(_CASES))
def test_spans_fill_timings(workload, case):
    cfg = _CASES[case]
    mr, tm, _ = _timed(workload, cfg)
    multi = tm["batches"] > 1
    assert multi == (case == "w20-multibatch")
    # Both cases' rows come back packed (the fields fit 64 bits).
    want = _ALWAYS | {"fetch.unpack"} | ({"union.cap", "union.rank"} if multi else set())
    assert set(tm["spans"]) == want
    assert all(v >= 0 for v in tm["spans"].values())
    assert set(tm["stages"]) == {"probe", "expand_verify", "rank"}


@pytest.mark.parametrize("case", list(_CASES))
def test_spans_tile_the_call(workload, case):
    """prepare, the loop (device_s, the union of several batches
    included), the fetch and the assembly cover the call's wall but for
    max(5 ms, 5%)."""
    _, tm, wall = _timed(workload, _CASES[case])
    sp = tm["spans"]
    covered = sp["prepare"] + tm["device_s"] + tm["fetch_s"] + sp["assemble"]
    assert covered <= wall
    assert wall - covered <= max(5e-3, 0.05 * wall), (wall, covered, sp)
    # The fetch's parts lie inside it, the upload's copy inside read_prep_s.
    assert sp["fetch.d2h"] + sp.get("fetch.unpack", 0.0) <= tm["fetch_s"]
    assert sp["upload.stage"] <= tm["read_prep_s"]


@pytest.mark.parametrize("case", list(_CASES))
def test_counts(workload, case):
    rs, _ = workload
    mr, tm, _ = _timed(workload, _CASES[case])
    c = tm["counts"]
    assert c["reads"] == rs.codes.shape[0]
    assert c["survivors"] >= c["retained"] > 0
    if tm["batches"] == 1:
        assert c["retained"] == len(mr.read_row) and "union_kept" not in c
    else:  # the union's cap and rank only drop rows
        assert c["retained"] >= c["union_kept"] == len(mr.read_row)


def test_clock_reads_leave_the_timed_windows(workload, monkeypatch):
    """The clock's sums (a device synchronise and the event reads on a
    card) run after fetch_s and device_s are taken."""
    monkeypatch.setenv("MUSCATO_STAGE_TIMES", "1")
    slow = 0.2
    for name in ("sums", "batch_sums"):
        orig = getattr(tpipeline._StageClock, name)
        monkeypatch.setattr(tpipeline._StageClock, name,
                            lambda self, _o=orig: (time.sleep(slow), _o(self))[1])
    _, tm, wall = _timed(workload, _CASES["w20"])
    assert wall > 2 * slow
    assert tm["fetch_s"] < slow and tm["device_s"] < wall - slow


def _profiled(workload, cfg):
    from torch.profiler import ProfilerActivity, profile

    rs, index = workload
    rs = _fresh(rs)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        mr = tpipeline.run_matching_indexed(cfg, rs, index)
    return mr, {e.name for e in prof.events()}


@pytest.mark.parametrize("case", list(_CASES))
def test_profiler_sees_the_host_ranges(workload, case):
    """Under torch.profiler, with no ``timings``, the host spans open their
    ranges, and no range is named for a device span (the union's too) or a
    blocking read."""
    mr, names = _profiled(workload, _CASES[case])
    ranges = {n for n in names if n.startswith("muscato.")}
    assert {"muscato.prepare", "muscato.upload.stage", "muscato.wait.total",
            "muscato.fetch.unpack", "muscato.assemble"} <= ranges
    assert "muscato.fetch.offset" not in ranges
    assert not {"muscato." + n for n in _DEVICE + _BLOCKING} & ranges
    plain = tpipeline.run_matching_indexed(_CASES[case], *workload)
    for f in ("read_row", "gene", "start", "nmiss"):  # the ranges change nothing
        np.testing.assert_array_equal(getattr(mr, f), getattr(plain, f))


@pytest.mark.parametrize("case", list(_CASES))
def test_tracing_off_records_nothing(workload, case, monkeypatch):
    """No ``timings``, no MUSCATO_STAGE_TIMES and no profiler: the call
    opens no record_function and makes no CUDA event."""
    monkeypatch.delenv("MUSCATO_STAGE_TIMES", raising=False)
    called = []

    def refuse(name):
        def fn(*a, **k):
            called.append(name)
            raise AssertionError(f"{name} called with tracing off")
        return fn

    plain = tpipeline.run_matching_indexed(_CASES[case], *workload)
    monkeypatch.setattr(torch.profiler, "record_function", refuse("record_function"))
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse("record_function"))
    monkeypatch.setattr(torch.cuda, "Event", refuse("Event"))
    monkeypatch.setattr(tpipeline._StageClock, "__init__", refuse("_StageClock"))
    got = tpipeline.run_matching_indexed(_CASES[case], *workload)
    assert called == []
    for f in ("read_row", "gene", "start", "nmiss"):
        np.testing.assert_array_equal(getattr(got, f), getattr(plain, f))


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "full-cols"])
def test_rank_spans(packed):
    """rank_survivors brackets its cap and its dedup with the span it is
    given, in that order, and returns what it returns without one."""
    rng = np.random.default_rng(7)
    n, live = 512, 400
    buf = torch.from_numpy(np.stack([
        rng.integers(0, 64, n), rng.integers(0, 50, n), rng.integers(0, 900, n),
        rng.integers(0, 4, n), rng.integers(0, 30, n), rng.integers(0, 30, n),
        rng.integers(0, 4, n)], 1).astype(np.int32))
    kw = dict(match_mode="best", full_cols=not packed,
              pack_bits=(6, 6, 10, 3) if packed else None)
    seen = []

    def span(name):
        seen.append(name)
        return tpipeline._NULL

    rows, count = fused.rank_survivors(buf, live, 3, 1, span=span, **kw)
    want_rows, want_count = fused.rank_survivors(buf, live, 3, 1, **kw)
    assert seen == ["rank.cap", "rank.dedup"]
    assert int(count) == int(want_count) > 0
    assert torch.equal(rows, want_rows)


_PROBE_SPANS = {"probe.queries", "probe.search", "probe.compact"}


@pytest.fixture(scope="module")
def targets():
    rs, ts = tgendat.generate_arrays_realistic(*_ARGS, seed=1)
    return rs, ts


def _search_index(targets, mode, monkeypatch):
    """A fresh index of ``targets`` whose search aux takes ``mode``: the
    direct layout, or the binary one below a capped bucket width."""
    from muscato_tpu_torch.engine import index as tindex

    if mode == "binary":
        monkeypatch.setattr(tindex, "MAX_DIRECT_BITS", 15)
    index = tpipeline.build_target_index(targets[1], 20, "cpu")
    assert index.search_aux().mode == mode
    return index


@pytest.mark.parametrize("case", list(_CASES))
@pytest.mark.parametrize("mode", ["direct", "binary"])
def test_search_probe_spans(targets, mode, case, monkeypatch):
    """A search-probe call opens the probe's three spans in every batch,
    inside its stage; the MatchResult is the sorted join's."""
    index = _search_index(targets, mode, monkeypatch)
    rs = targets[0]
    tm = {}
    mr = tpipeline.run_matching_indexed(_CASES[case], _fresh(rs), index, probe="search",
                                        timings=tm)
    assert tm["probe_kind"] == mode
    sp = tm["spans"]
    assert _PROBE_SPANS <= set(sp)
    assert all(sp[n] > 0 for n in _PROBE_SPANS)
    assert sum(sp[n] for n in _PROBE_SPANS) <= tm["stages"]["probe"]
    plain = tpipeline.run_matching_indexed(_CASES[case], _fresh(rs), index, probe="sort")
    for f in ("read_row", "gene", "start", "nmiss"):
        np.testing.assert_array_equal(getattr(mr, f), getattr(plain, f))


@pytest.mark.parametrize("case", list(_CASES))
def test_sorted_join_opens_no_probe_span(workload, case):
    _, tm, _ = _timed(workload, _CASES[case])
    assert tm["probe_kind"] == "sorted_join"
    assert not _PROBE_SPANS & set(tm["spans"])


@pytest.mark.parametrize("mode", ["direct", "binary"])
def test_search_probe_tracing_off_records_nothing(targets, mode, monkeypatch):
    """A search-probe call with tracing off opens no range, makes no clock
    and no CUDA event; under the profiler its device spans open no
    range."""
    monkeypatch.delenv("MUSCATO_STAGE_TIMES", raising=False)
    index = _search_index(targets, mode, monkeypatch)
    rs, cfg = targets[0], _CASES["w20-multibatch"]
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        mr = tpipeline.run_matching_indexed(cfg, _fresh(rs), index, probe="search")
    names = {e.name for e in prof.events()}
    assert "muscato.prepare" in names
    assert not {"muscato." + n for n in _PROBE_SPANS} & names
    called = []

    def refuse(name):
        def fn(*a, **k):
            called.append(name)
            raise AssertionError(f"{name} called with tracing off")
        return fn

    monkeypatch.setattr(torch.profiler, "record_function", refuse("record_function"))
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse("record_function"))
    monkeypatch.setattr(torch.cuda, "Event", refuse("Event"))
    monkeypatch.setattr(tpipeline._StageClock, "__init__", refuse("_StageClock"))
    got = tpipeline.run_matching_indexed(cfg, _fresh(rs), index, probe="search")
    assert called == []
    for f in ("read_row", "gene", "start", "nmiss"):
        np.testing.assert_array_equal(getattr(got, f), getattr(mr, f))
