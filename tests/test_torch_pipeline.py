"""The port's whole matching path (muscato_tpu_torch.engine.pipeline)
against the JAX engine's run_matching on the same realistic workload.

MatchResult must be identical: width 10 and width 20, single-batch and
multi-batch (a small ReadBatch), and a binding MaxMatches cap.  Both
packages auto-select the probe (here the sorted join: the index is small
against the batch's queries); under the JAX package's switches the port
takes the sort-merge probe
(MUSCATO_PJOIN=0) and the sub-chunked B6 expand (MUSCATO_PEXPAND_SUB=1) —
the retained set is the contract.  Each package gets its own ReadSet,
TargetSet and Config, made by its own gendat and config module.
"""

import contextlib
import dataclasses
import importlib
import logging
import re

import numpy as np
import pytest
import torch

from muscato_tpu import config as jconfig
from muscato_tpu.bench import gendat as jgendat
from muscato_tpu.engine import pipeline as jpipeline
from muscato_tpu_torch import config as tconfig
from muscato_tpu_torch.bench import gendat as tgendat
from muscato_tpu_torch.device import resolve_device
from muscato_tpu_torch.engine import pipeline as tpipeline
from muscato_tpu_torch.ops import expand, gather, join, window_queries

_ARGS = (5000, 100, 200, 1000)


@pytest.fixture(scope="module")
def workload():
    """The port's ReadSet and TargetSet."""
    return tgendat.generate_arrays_realistic(*_ARGS, seed=1)


@pytest.fixture(scope="module")
def jax_workload():
    """The same workload made by the JAX package's gendat."""
    return jgendat.generate_arrays_realistic(*_ARGS, seed=1)


def _cfg(width, windows, min_dinuc, mode="best", mm=10**6, batch=0,
         config=tconfig):
    return config.Config(
        Windows=list(windows), WindowWidth=width, PMatch=0.96,
        MinDinuc=min_dinuc, MaxReadLength=200, MMTol=2, MaxMatches=mm,
        MatchMode=mode, ReadBatch=batch,
    )


_JAX_RESULTS = {}


def _jax_result(jax_workload, cfg):
    """The JAX engine's MatchResult for the port's config ``cfg`` (computed
    once per config in this module)."""
    key = repr(dataclasses.asdict(cfg))
    if key not in _JAX_RESULTS:
        jcfg = jconfig.Config(**dataclasses.asdict(cfg))
        _JAX_RESULTS[key] = jpipeline.run_matching(jcfg, *jax_workload)
    return _JAX_RESULTS[key]


def _assert_same(got, exp):
    assert len(exp.read_row) > 0
    for f in ("read_row", "gene", "start", "nmiss"):
        np.testing.assert_array_equal(getattr(got, f), getattr(exp, f), err_msg=f)


@pytest.mark.parametrize(
    "cfg",
    [
        _cfg(20, (10, 30, 50, 70), 3),
        _cfg(10, (0, 20, 45), 2),
        _cfg(20, (10, 30, 50, 70), 3, batch=2048),  # three batches
        _cfg(10, (0, 20, 45), 0, mode="first", mm=2),  # the cap binds
        _cfg(10, (0, 20, 45), 0, mode="first", mm=2, batch=2048),
        _cfg(10, (0, 20, 45), 0, mode="best", mm=2, batch=2048),
        # Narrow windows share their k-mers across batches, so that the
        # union's cap drops rows that each batch's own rank kept.
        _cfg(5, (0, 20, 45), 0, mode="first", mm=1, batch=2048),
        _cfg(6, (0, 20, 45), 0, mode="best", mm=1, batch=2048),
    ],
    ids=["w20", "w10", "w20-multibatch", "w10-first-capped", "w10-first-capped-multibatch",
         "w10-best-capped-multibatch", "w5-first-capped-multibatch",
         "w6-best-capped-multibatch"],
)
def test_run_matching_matches_jax(workload, jax_workload, cfg):
    rs, ts = workload
    exp = _jax_result(jax_workload, cfg)
    timings = {}
    index = tpipeline.build_target_index(ts, cfg.WindowWidth, "cpu")
    got = tpipeline.run_matching_indexed(cfg, rs, index, timings=timings)
    _assert_same(got, exp)
    assert set(timings["stages"]) == {"probe", "expand_verify", "rank"}
    assert timings["batches"] == -(-rs.num_unique // (cfg.ReadBatch or 1 << 22))
    counts = timings["counts"]
    if timings["batches"] == 1:
        assert "union_kept" not in counts
    else:
        assert counts["union_kept"] == len(got.read_row) <= counts["retained"]
        if cfg.MaxMatches == 1:  # the cross-batch cap engages
            assert counts["union_kept"] < counts["retained"]


@pytest.mark.parametrize("width,mode", [(5, "first"), (6, "best")])
def test_union_fetches_unpacked_rows_where_the_bits_do_not_fit(
        workload, jax_workload, width, mode, monkeypatch):
    """Where the 64-bit packed fetch cannot hold the fields, the union of
    several batches returns four int32 columns, with the same MatchResult
    and no unpack."""
    rs, ts = workload
    cfg = _cfg(width, (0, 20, 45), 0, mode=mode, mm=1, batch=2048)
    index = tpipeline.build_target_index(ts, cfg.WindowWidth, "cpu")
    packed_timings, timings = {}, {}
    packed = tpipeline.run_matching_indexed(cfg, rs, index, timings=packed_timings)
    monkeypatch.setattr(tpipeline, "_fetch_pack_bits", lambda *a: None)
    got = tpipeline.run_matching_indexed(cfg, rs, index, timings=timings)
    _assert_same(got, packed)
    _assert_same(got, _jax_result(jax_workload, cfg))
    assert "fetch.unpack" in packed_timings["spans"] and "fetch.unpack" not in timings["spans"]
    assert timings["fetch_bytes"] == 16 * len(got.read_row)
    assert packed_timings["fetch_bytes"] == 8 * len(got.read_row)


@pytest.mark.parametrize("switch", ["MUSCATO_PJOIN=0", "MUSCATO_PEXPAND_SUB=1"])
@pytest.mark.parametrize(
    "cfg",
    [
        _cfg(20, (10, 30, 50, 70), 3),
        _cfg(10, (0, 20, 45), 0, mode="first", mm=2),
        _cfg(20, (10, 30, 50, 70), 3, batch=2048),
    ],
    ids=["w20", "w10-first-capped", "w20-multibatch"],
)
def test_switched_paths_match_jax(workload, jax_workload, cfg, switch, monkeypatch):
    """The sort-merge probe and the B6 expand, each selected by its switch
    when the run starts, give the JAX engine's MatchResult."""
    name, value = switch.split("=")
    monkeypatch.setenv(name, value)
    rs, ts = workload
    index = tpipeline.build_target_index(ts, cfg.WindowWidth, "cpu")
    called = []
    for mod, fn in ((tpipeline.fused, "_probe_windows_impl"),
                    (tpipeline.fused, "_probe_windows_pjoin_impl"),
                    (expand, "expand_owners_sub")):
        orig = getattr(mod, fn)
        monkeypatch.setattr(mod, fn, lambda *a, _o=orig, _n=fn, **k: (called.append(_n), _o(*a, **k))[1])
    got = tpipeline.run_matching_indexed(cfg, rs, index)
    _assert_same(got, _jax_result(jax_workload, cfg))
    if name == "MUSCATO_PJOIN":
        assert "_probe_windows_impl" in called and "_probe_windows_pjoin_impl" not in called
        assert "expand_owners_sub" not in called
    else:
        assert "_probe_windows_pjoin_impl" in called and "expand_owners_sub" in called


def test_survivor_capacity_regrows(workload, monkeypatch):
    """A survivor buffer smaller than the batch's survivors grows to the
    bucket that covers them, with the same results, and the grown
    capacity is kept for later runs (the process-wide hint)."""
    rs, ts = workload
    cfg = _cfg(20, (10, 30, 50, 70), 3)
    exp = tpipeline.run_matching(cfg, rs, ts, device="cpu")
    monkeypatch.setattr(tpipeline, "_SURV_CAP0", 64)
    monkeypatch.setattr(tpipeline, "_CAP_HINT", [64])
    _assert_same(tpipeline.run_matching(cfg, rs, ts, device="cpu"), exp)
    assert tpipeline._CAP_HINT[0] >= len(exp.read_row)


def test_cuda_is_never_picked_silently():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.gpu
def test_cuda_run_matches_cpu_run(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rs, ts = workload
    cfg = _cfg(20, (10, 30, 50, 70), 3)
    fns = (join.sorted_join, expand.expand_owners, gather.monotone_gather,
           gather.monotone_gather_rows, window_queries.window_queries)
    before = [f.launches for f in fns]
    got = tpipeline.run_matching(cfg, rs, ts, device="cuda")
    assert all(f.launches > b for f, b in zip(fns, before))
    _assert_same(got, tpipeline.run_matching(cfg, rs, ts, device="cpu"))


@pytest.mark.gpu
def test_cuda_switched_run_matches_cpu_run(workload, monkeypatch):
    """Both switches at once on the card: no B1, one B6 per batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setenv("MUSCATO_PJOIN", "0")
    monkeypatch.setenv("MUSCATO_PEXPAND_SUB", "1")
    rs, ts = workload
    cfg = _cfg(20, (10, 30, 50, 70), 3)
    before = (join.sorted_join.launches, expand.expand_owners_sub.launches)
    got = tpipeline.run_matching(cfg, rs, ts, device="cuda")
    assert join.sorted_join.launches == before[0]
    assert expand.expand_owners_sub.launches == before[1] + 1
    _assert_same(got, tpipeline.run_matching(cfg, rs, ts, device="cpu"))


def _ragged_workload(pkg, seed=5, nreads=3000, ngenes=300):
    """Reads of 20-150 bases, a tenth random, the rest drawn from genes of
    50-1,500 bases with 3% substitutions; X codes at 1-5% (a rate drawn
    for each read and gene) in reads and genes.  Made with numpy from
    ``seed`` into the ReadSet and TargetSet classes of ``pkg`` (the JAX
    package or the port)."""
    rng = np.random.default_rng(seed)
    glens = rng.integers(50, 1501, ngenes)
    gene_start = np.concatenate([[0], np.cumsum(glens)]).astype(np.int64)
    tcat = rng.integers(0, 4, int(gene_start[-1])).astype(np.uint8)
    gx = np.repeat(rng.uniform(0.01, 0.05, ngenes), glens)
    tcat[rng.random(len(tcat)) < gx] = 4
    lmax = 150
    lengths = rng.integers(20, lmax + 1, nreads).astype(np.int32)
    codes = rng.integers(0, 4, (nreads, lmax)).astype(np.uint8)
    for i in range(nreads // 10, nreads):
        fits = np.flatnonzero(glens >= lengths[i])
        g = rng.choice(fits)
        off = gene_start[g] + rng.integers(0, glens[g] - lengths[i] + 1)
        codes[i, : lengths[i]] = tcat[off: off + lengths[i]]
        mut = rng.random(lengths[i]) < 0.03
        codes[i, : lengths[i]][mut] = rng.integers(0, 4, int(mut.sum()))
    codes[rng.random(codes.shape) < rng.uniform(0.01, 0.05, (nreads, 1))] = 4
    codes[np.arange(lmax)[None, :] >= lengths[:, None]] = 0
    keyed = np.ascontiguousarray(np.concatenate(
        [codes, lengths.astype(np.uint8)[:, None]], axis=1))
    _, first, counts = np.unique(keyed.view(f"V{lmax + 1}").ravel(), return_index=True,
                                 return_counts=True)
    reads = importlib.import_module(f"{pkg}.io.reads")
    targets = importlib.import_module(f"{pkg}.io.targets")
    rs = reads.ReadSet(codes=codes[first], lengths=lengths[first],
                       counts=counts.astype(np.int64),
                       names=[b"read_%d" % i for i in range(len(first))], num_total=nreads)
    ts = targets.TargetSet(tcat=tcat, gene_start=gene_start,
                           names=[b"gene_%d" % i for i in range(ngenes)],
                           lengths=np.diff(gene_start))
    return rs, ts


@pytest.mark.parametrize(
    "cfg",
    [
        _cfg(12, (0, 15, 40, 70), 2),
        _cfg(20, (10, 30, 50, 70), 3),
        _cfg(32, (0, 40, 90), 3),
        _cfg(20, (0, 25, 60, 100), 3, mode="first", mm=3, batch=1024),  # three batches
        _cfg(16, (5, 45, 85), 2, mm=1),
    ],
    ids=["w12", "w20", "w32", "w20-first-capped-multibatch", "w16-best-max1"],
)
def test_ragged_reads_match_jax(cfg):
    """Reads of 20-150 bases with X codes: the verify's length masks and
    budgets vary lane by lane.  The port's run_matching gives the JAX
    engine's MatchResult."""
    exp = jpipeline.run_matching(jconfig.Config(**dataclasses.asdict(cfg)),
                                 *_ragged_workload("muscato_tpu"))
    rs, ts = _ragged_workload("muscato_tpu_torch")
    assert len(set(rs.lengths.tolist())) > 100
    got = tpipeline.run_matching(cfg, rs, ts, device="cpu")
    _assert_same(got, exp)


def _two_batch_cfg(rs, config=tconfig):
    """The w20 config with a ReadBatch that splits ``rs`` into two batches."""
    cfg = _cfg(20, (10, 30, 50, 70), 3, batch=4096, config=config)
    assert -(-rs.num_unique // cfg.ReadBatch) == 2
    return cfg


@contextlib.contextmanager
def _pipeline_log():
    """The messages logged to "muscato.pipeline" (the logger name of both
    packages) inside the block, captured by a handler of its own."""
    lines = []
    handler = logging.Handler(logging.INFO)
    handler.emit = lambda rec: lines.append(rec.getMessage())
    lg = logging.getLogger("muscato.pipeline")
    level = lg.level
    lg.setLevel(logging.INFO)
    lg.addHandler(handler)
    try:
        yield lines
    finally:
        lg.removeHandler(handler)
        lg.setLevel(level)


def _stage_lines(lines):
    """The stage lines, numbers masked."""
    return [re.sub(r"\d+(\.\d+)?", "#", ln) for ln in lines
            if ln.startswith(("stage times ", "stage sums "))]


def test_stage_times_lines_match_jax(workload, jax_workload, monkeypatch):
    """MUSCATO_STAGE_TIMES=1: one "stage times" line a batch and one
    "stage sums" line, with the JAX engine's text (numbers masked), and
    the batch bounds of JAX's lines, then the port's kernel launches;
    without the switch the port logs none and its MatchResult does not
    move."""
    rs, ts = workload
    cfg = _two_batch_cfg(rs)
    index = tpipeline.build_target_index(ts, cfg.WindowWidth, "cpu")
    with _pipeline_log() as quiet:
        plain = tpipeline.run_matching_indexed(cfg, rs, index)
    assert _stage_lines(quiet) == []
    monkeypatch.setenv("MUSCATO_STAGE_TIMES", "1")
    with _pipeline_log() as jlines:
        exp = jpipeline.run_matching(_two_batch_cfg(jax_workload[0], jconfig), *jax_workload)
    with _pipeline_log() as tlines:
        got = tpipeline.run_matching_indexed(cfg, rs, index)
    _assert_same(got, exp)
    _assert_same(plain, exp)
    masked = _stage_lines(tlines)
    assert masked == _stage_lines(jlines)
    assert [ln.startswith("stage times ") for ln in masked] == [True, True, False]
    (launches,) = [ln for ln in tlines if ln.startswith("kernel launches ")]
    assert launches == "kernel launches over 2 batches: " + " ".join(
        f"{k}=0" for k in tpipeline.KERNELS)  # the CPU runs the plain twins
    bounds = lambda lines: [ln.split(")")[0] for ln in lines if ln.startswith("stage times ")]  # noqa: E731
    assert bounds(tlines) == bounds(jlines) == [
        f"stage times [0,{cfg.ReadBatch}", f"stage times [{cfg.ReadBatch},{rs.num_unique}"]


def test_stage_clock_sums_by_batch():
    """The clock books each span to its batch (the current one, or the tag
    a prefetched probe names), and its sums over every span are the sums
    of its batches'."""
    clock = tpipeline._StageClock(torch.device("cpu"))
    clock.tag = 0
    with clock.span("probe"):
        pass
    with clock.span("probe", 8):
        pass
    with clock.span("rank"):
        pass
    clock.tag = 8
    with clock.span("rank"):
        pass
    by_batch = clock.batch_sums()
    assert {t: sorted(s) for t, s in by_batch.items()} == {
        0: ["probe", "rank"], 8: ["probe", "rank"]}
    total = clock.sums()
    assert sorted(total) == ["probe", "rank"]
    for name in total:
        assert total[name] == pytest.approx(sum(s[name] for s in by_batch.values()))
