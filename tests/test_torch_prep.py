"""The port's read prep against the JAX package's on the same files:
``io/reads.py`` build_readset_chunked over a fastq that spills many sorted
runs (chunk sizes that split duplicate groups across runs, names that
join, reads past MaxReadLength, reads below MinReadLength), and the
sorted-reads file the driver writes, ``reads_sorted.txt.sz``, kept under
NoCleanTemp, byte for byte (both packages on one native codec,
tests/native_codec.py)."""

import os

import numpy as np
import pytest

from muscato_tpu import config as jconfig
from muscato_tpu.engine import driver as jdriver
from muscato_tpu.io import reads as jreads
from muscato_tpu_torch import config as tconfig
from muscato_tpu_torch.bench import gendat as tgendat
from muscato_tpu_torch.engine import driver as tdriver
from muscato_tpu_torch.io import reads as treads
from muscato_tpu_torch.io import targets
from native_codec import same_codec  # noqa: F401 (a fixture)
from test_sharded_prep import _mk_fastq


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    """5,000 records over 600 sequences of 5-60 bases, so duplicate groups
    span many runs; names of 3-40 bytes, some long enough that joined
    names pass the truncation."""
    rng = np.random.default_rng(13)
    pool = ["".join("ACGTN"[i] for i in rng.integers(0, 5, rng.integers(5, 61)))
            for _ in range(600)]
    records = []
    for i in range(5000):
        seq = pool[int(rng.integers(len(pool)))] if i % 9 else pool[i % 7]
        name = f"@r{rng.integers(10**6)}_{i}" + "x" * int(rng.integers(0, 30))
        records.append((name, seq))
    return _mk_fastq(tmp_path_factory.mktemp("prep"), records)


def _same_readset(a, b):
    np.testing.assert_array_equal(a.codes, b.codes)
    np.testing.assert_array_equal(a.lengths, b.lengths)
    np.testing.assert_array_equal(a.counts, b.counts)
    np.testing.assert_array_equal(a.name_blob, b.name_blob)
    np.testing.assert_array_equal(a.name_off, b.name_off)
    assert a.num_total == b.num_total and a.num_unique == b.num_unique


@pytest.mark.parametrize("chunk", [37, 100, 999, 4096])
def test_chunked_readset_matches_jax(fastq, chunk):
    """Codes, lengths, counts, names and their order equal the JAX
    function's at chunk sizes that spill 2 to 136 runs."""
    got = treads.build_readset_chunked(fastq, 8, 50, chunk)
    exp = jreads.build_readset_chunked(fastq, 8, 50, chunk)
    assert got.num_unique > 400 and (np.asarray(got.counts) > 1).any()
    _same_readset(got, exp)


def test_chunked_readset_tiny_merge_block_matches_jax(fastq, monkeypatch):
    """With a merge block smaller than the duplicate groups both packages
    pull groups across many merge iterations; still equal."""
    monkeypatch.setattr(treads, "_merge_block_rows", lambda nruns: 4)
    monkeypatch.setattr(jreads, "_merge_block_rows", lambda nruns: 4)
    _same_readset(treads.build_readset_chunked(fastq, 0, 60, 53),
                  jreads.build_readset_chunked(fastq, 0, 60, 53))


@pytest.fixture(scope="module")
def driver_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("sorted_reads")
    reads, genes = tgendat.generate_big(1200, 100, 40, 1000, out_dir=str(d), seed=9,
                                        hit_frac=0.6)
    seq, ids = targets.prep_targets(genes, rev=False)
    return d, reads, seq, ids


@pytest.mark.usefixtures("same_codec")
@pytest.mark.parametrize("prep_chunk", [0, 97])
def test_reads_sorted_file_matches_jax_driver(driver_files, prep_chunk):
    """reads_sorted.txt.sz in the TempDir each driver keeps under
    NoCleanTemp: the port's bytes equal the JAX driver's, with the
    in-memory prep and the chunked one."""
    d, reads, seq, ids = driver_files
    out = {}
    for name, config, run in (("jax", jconfig, jdriver.run),
                              ("port", tconfig, lambda c: tdriver.run(c, device="cpu"))):
        tag = f"{name}_{prep_chunk}"
        cfg = config.Config(
            ReadFileName=reads, GeneFileName=seq, GeneIdFileName=ids,
            ResultsFileName=str(d / f"{tag}.txt"), Windows=[10, 30, 50, 70],
            WindowWidth=20, PMatch=0.96, MinDinuc=3, MaxReadLength=200, MMTol=2,
            TempDir=str(d / f"tmp_{tag}"), LogDir=str(d / f"logs_{tag}"), Mesh="off",
            PrepChunk=prep_chunk, NoCleanTemp=True,
        )
        config.apply_defaults(cfg)
        run(cfg)  # sets cfg.TempDir to the run's own directory
        with open(os.path.join(cfg.TempDir, "reads_sorted.txt.sz"), "rb") as f:
            out[name] = f.read()
    assert len(out["jax"]) > 1000
    assert out["port"] == out["jax"]
