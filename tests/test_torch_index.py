"""The port's target index against the JAX package's: gene-range
sharding (three shards in both packages, equal to each other and to the
unsharded run; targets past 2**31-1 bases routed to the shards) and the
index file (written by either package, loaded by the other, the same
arrays and MatchResult; a file for another version, width or base count
refused by both).
"""

import dataclasses

import numpy as np
import pytest
import torch

from muscato_tpu import config as jconfig
from muscato_tpu.bench import gendat as jgendat
from muscato_tpu.engine import index as jindex
from muscato_tpu.engine import pipeline as jpipeline
from muscato_tpu_torch import config as tconfig
from muscato_tpu_torch.bench import gendat as tgendat
from muscato_tpu_torch.engine import index as tindex
from muscato_tpu_torch.engine import pipeline as tpipeline
from muscato_tpu_torch.io.targets import TargetSet

_ARGS = (5000, 100, 200, 1000)  # tests/test_torch_pipeline.py's workload


@pytest.fixture(scope="module")
def workload():
    return tgendat.generate_arrays_realistic(*_ARGS, seed=1)


@pytest.fixture(scope="module")
def jax_workload():
    return jgendat.generate_arrays_realistic(*_ARGS, seed=1)


def _cfg(batch=0):
    return tconfig.Config(
        Windows=[10, 30, 50, 70], WindowWidth=20, PMatch=0.96, MinDinuc=3,
        MaxReadLength=200, MMTol=2, MaxMatches=10**6, MatchMode="best",
        ReadBatch=batch,
    )


def _jcfg(cfg):
    return jconfig.Config(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def jax_result(jax_workload):
    """The JAX engine's unsharded MatchResult of ``_cfg()``."""
    return jpipeline.run_matching(_jcfg(_cfg()), *jax_workload)


def _assert_same(got, exp):
    assert len(exp.read_row) > 0
    for f in ("read_row", "gene", "start", "nmiss"):
        np.testing.assert_array_equal(getattr(got, f), getattr(exp, f), err_msg=f)


# ---- gene-range sharding ---------------------------------------------------


def test_gene_sharded_matches_jax(workload, jax_workload, jax_result):
    """Three gene-range shards in both packages: equal to each other and
    to the unsharded run; in the port also with each shard's reads in
    three batches."""
    exp = jpipeline.run_matching_gene_sharded(_jcfg(_cfg()), *jax_workload, 3)
    _assert_same(exp, jax_result)
    for batch in (0, 2048):
        timings = {}
        got = tpipeline.run_matching_gene_sharded(_cfg(batch), *workload, 3,
                                                  device="cpu", timings=timings)
        _assert_same(got, exp)
        assert [s["genes"] for s in timings["shards"]] == [[0, 67], [67, 134], [134, 200]]


def test_run_matching_shards_past_int32(workload, monkeypatch):
    """Targets above 2**31-1 bases go to the gene-range shards, as many as
    keep each below 3 * 2**29 bases; build_target_index refuses them."""
    rs, _ = workload
    big = TargetSet(tcat=np.zeros(0, np.uint8),
                    gene_start=np.array([0, 2**31, 2**32 + 7], np.int64),
                    names=[b"a", b"b"], lengths=np.array([2**31, 2**31 + 7]))
    seen = []
    monkeypatch.setattr(tpipeline, "run_matching_gene_sharded",
                        lambda cfg, rs, ts, n, *, device: seen.append((n, device)))
    tpipeline.run_matching(_cfg(), rs, big, device="cpu")
    assert seen == [(3, "cpu")]
    with pytest.raises(NotImplementedError, match="gene range"):
        tpipeline.build_target_index(big, 20, "cpu")


# ---- the index file --------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_index_file_crosses_packages(workload, jax_workload, jax_result, tmp_path,
                                     writer):
    """An index file written by either package loads in the other: the
    same arrays (skeys2 included) and the same MatchResult."""
    cfg = _cfg()
    rs, ts = workload
    path = str(tmp_path / "index.npz")
    ji = jindex.build_target_index(jax_workload[1], 20)
    ti = tindex.build_target_index(ts, 20, "cpu")
    (ji if writer == "jax" else ti).save(path)
    jl = jindex.TargetIndex.load(path, jax_workload[1], 20)
    tl = tindex.TargetIndex.load(path, ts, 20, "cpu")
    for a, b in zip(tl.host_arrays, ji.host_arrays):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (tl.num_valid, tl.num_bases) == (ti.num_valid, ti.num_bases)
    for f in ("skeys", "spos", "tpacked", "gene_start"):
        assert torch.equal(getattr(tl, f), getattr(ti, f)), f
    _assert_same(tpipeline.run_matching_indexed(cfg, rs, tl), jax_result)
    _assert_same(jpipeline.run_matching_indexed(_jcfg(cfg), jax_workload[0], jl),
                 jax_result)


@pytest.mark.parametrize("field,value", [("version", 3), ("width", 21),
                                         ("num_bases", 12345)])
def test_index_file_mismatch_raises(workload, jax_workload, tmp_path, field, value):
    """A file of another format version, width or base count raises
    ValueError in both packages."""
    ts = workload[1]
    path = str(tmp_path / "index.npz")
    tindex.build_target_index(ts, 20, "cpu").save(path)
    d = dict(np.load(path))
    d[field] = np.int64(value)
    np.savez(path, **d)
    with pytest.raises(ValueError, match="index file"):
        tindex.TargetIndex.load(path, ts, 20, "cpu")
    with pytest.raises(ValueError, match="index file"):
        jindex.TargetIndex.load(path, jax_workload[1], 20)
