"""The port's whole matching path (muscato_tpu_torch.engine.pipeline)
against the JAX engine's run_matching on the same realistic workload.

MatchResult must be identical: width 10 and width 20, single-batch and
multi-batch (a small ReadBatch), and a binding MaxMatches cap.  The JAX
run takes whichever probe it auto-selects; the port takes the sorted-join
probe, or under the JAX package's switches the sort-merge probe
(MUSCATO_PJOIN=0) and the sub-chunked B6 expand (MUSCATO_PEXPAND_SUB=1) —
the retained set is the contract.  Each package gets its own ReadSet,
TargetSet and Config, made by its own gendat and config module.
"""

import dataclasses

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
    ],
    ids=["w20", "w10", "w20-multibatch", "w10-first-capped"],
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
    bucket that covers them, with the same results."""
    rs, ts = workload
    cfg = _cfg(20, (10, 30, 50, 70), 3)
    exp = tpipeline.run_matching(cfg, rs, ts, device="cpu")
    monkeypatch.setattr(tpipeline, "_SURV_CAP0", 64)
    _assert_same(tpipeline.run_matching(cfg, rs, ts, device="cpu"), exp)


def test_unported_paths_raise(workload, monkeypatch):
    rs, ts = workload
    index = tpipeline.build_target_index(ts, 20, "cpu")
    with pytest.raises(NotImplementedError, match="streaming expand"):
        tpipeline.run_matching_indexed(
            dataclasses.replace(_cfg(20, (10, 30), 3), NoDedup=True), rs, index
        )
    with pytest.raises(NotImplementedError, match="streaming expand"):
        tpipeline.run_matching_indexed(_cfg(20, tuple(range(32)), 3), rs, index)
    with pytest.raises(NotImplementedError, match="probe"):
        tpipeline.run_matching_indexed(_cfg(20, (10,), 3), rs, index, probe="search")
    monkeypatch.setattr(tpipeline, "_MAX_PAIR_CAP", 16)
    with pytest.raises(NotImplementedError, match="streaming expand"):
        tpipeline.run_matching_indexed(_cfg(20, (10,), 3), rs, index)


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
