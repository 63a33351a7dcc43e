"""The port's whole matching path (muscato_tpu_torch.engine.pipeline)
against the JAX engine's run_matching on the same realistic workload.

MatchResult must be identical: width 10 and width 20, single-batch and
multi-batch (a small ReadBatch), and a binding MaxMatches cap.  The JAX
run takes whichever probe it auto-selects; the port always takes the
sorted-join probe — the retained set is the contract.
"""

import dataclasses

import numpy as np
import pytest
import torch

from muscato_tpu.bench import gendat
from muscato_tpu.config import Config
from muscato_tpu.engine import pipeline as jpipeline
from muscato_tpu_torch.device import resolve_device
from muscato_tpu_torch.engine import pipeline as tpipeline
from muscato_tpu_torch.ops import expand, gather, join


@pytest.fixture(scope="module")
def workload():
    return gendat.generate_arrays_realistic(5000, 100, 200, 1000, seed=1)


def _cfg(width, windows, min_dinuc, mode="best", mm=10**6, batch=0):
    return Config(
        Windows=list(windows), WindowWidth=width, PMatch=0.96,
        MinDinuc=min_dinuc, MaxReadLength=200, MMTol=2, MaxMatches=mm,
        MatchMode=mode, ReadBatch=batch,
    )


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
def test_run_matching_matches_jax(workload, cfg):
    rs, ts = workload
    exp = jpipeline.run_matching(cfg, rs, ts)
    timings = {}
    index = tpipeline.build_target_index(ts, cfg.WindowWidth, "cpu")
    got = tpipeline.run_matching_indexed(cfg, rs, index, timings=timings)
    _assert_same(got, exp)
    assert set(timings["stages"]) == {"probe", "expand_verify", "rank"}
    assert timings["batches"] == -(-rs.num_unique // (cfg.ReadBatch or 1 << 22))


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
    before = [f.launches for f in (join.sorted_join, expand.expand_owners,
                                   gather.monotone_gather, gather.monotone_gather_rows)]
    got = tpipeline.run_matching(cfg, rs, ts, device="cuda")
    after = [f.launches for f in (join.sorted_join, expand.expand_owners,
                                  gather.monotone_gather, gather.monotone_gather_rows)]
    assert all(a > b for a, b in zip(after, before))
    _assert_same(got, tpipeline.run_matching(cfg, rs, ts, device="cpu"))
