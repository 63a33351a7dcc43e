"""The port's reference-scale scripts (muscato_tpu_torch/scripts/) against
the JAX package's (scripts/): gen_parallel writes the same bytes, run_100m's
gen equals gendat.generate_big, run_100m's run writes the same report
files and run100m.json keys as the JAX script's run, and it prepares the
targets again when a prepared file is missing, empty or older than the
gene file.  The JAX scripts run in child processes with this process's
environment (tests/conftest.py: JAX on the CPU, MUSCATO_TUNED=/nonexistent);
the port's run takes ``--device cpu``.
"""

import filecmp
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from muscato_tpu.bench import gendat as jgendat
from muscato_tpu_torch.bench import gendat as tgendat
from muscato_tpu_torch.scripts import run_100m
from native_codec import run_settled, same_codec  # noqa: F401 (a fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPORTS = ("results.txt", "results.nonmatch.txt.fastq", "results_readstats.txt",
           "results_genestats.txt")


def _run(argv, **env):
    subprocess.run([sys.executable, *argv], cwd=ROOT, check=True,
                   env=dict(os.environ, **env), stdout=subprocess.DEVNULL)


def test_gen_parallel_matches_jax(tmp_path):
    """600 reads in chunks of 200 over two workers (three chunks), at the
    scripts' full gene size: reads.fastq and genes.txt.sz byte-identical,
    the two scripts run while the native library stays as it is."""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"

    def run():
        for d in (jdir, tdir):
            shutil.rmtree(d, ignore_errors=True)
        _run(["scripts/gen_parallel.py", str(jdir), "600", "2"], GEN_CHUNK="200")
        _run(["-m", "muscato_tpu_torch.scripts.gen_parallel", str(tdir), "600", "2"],
             GEN_CHUNK="200")

    run_settled(run)
    for name in ("reads.fastq", "genes.txt.sz"):
        assert filecmp.cmp(jdir / name, tdir / name, shallow=False), name
    assert sorted(os.listdir(tdir)) == ["genes.txt.sz", "reads.fastq"]
    with open(tdir / "reads.fastq", "rb") as f:
        names = f.read().split(b"\n")[0::4]
    assert names[:2] == [b"read_0", b"read_1"] and names[599] == b"read_599"


@pytest.mark.usefixtures("same_codec")
def test_run_100m_gen_matches_generate_big(tmp_path, monkeypatch):
    """The twin's gen is generate_big with the JAX script's arguments."""
    monkeypatch.setenv("N_READS", "500")
    tdir, jdir = tmp_path / "port", tmp_path / "jax"
    jdir.mkdir()
    assert run_100m.main(["gen", str(tdir)]) == 0
    jgendat.generate_big(500, 100, 100000, 1000, out_dir=str(jdir), seed=7,
                         chunk=10000000, hit_frac=0.5)
    for name in ("reads.fastq", "genes.txt.sz"):
        assert filecmp.cmp(jdir / name, tdir / name, shallow=False), name
    with open(tdir / "run100m.json") as f:
        rec = json.load(f)
    assert set(rec) == {"n_reads", "gen_s", "fastq_bytes"} and rec["n_reads"] == 500
    assert rec["fastq_bytes"] == os.path.getsize(jdir / "reads.fastq")


@pytest.fixture(scope="module")
def small_data(tmp_path_factory):
    """2,000 reads against 200 genes x 1,000 bases from generate_big."""
    d = tmp_path_factory.mktemp("small")
    tgendat.generate_big(2000, 100, 200, 1000, out_dir=str(d), seed=7, hit_frac=0.5)
    return d


def test_run_100m_run_matches_jax(small_data, tmp_path):
    """The JAX script's run and the twin's run --device cpu on copies of
    one data directory: the four report files byte-identical, the same
    run100m.json keys and value types, and the twin's driver log holds
    one stage-times line and the stage sums."""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    shutil.copytree(small_data, jdir)
    shutil.copytree(small_data, tdir)
    _run(["scripts/run_100m.py", "run", str(jdir)], N_READS="2000")
    _run(["-m", "muscato_tpu_torch.scripts.run_100m", "run", str(tdir), "--device", "cpu"],
         N_READS="2000")
    for name in REPORTS:
        assert filecmp.cmp(jdir / name, tdir / name, shallow=False), name
    recs = []
    for d in (jdir, tdir):
        with open(d / "run100m.json") as f:
            recs.append(json.load(f))
    assert {k: type(v) for k, v in recs[1].items()} == {k: type(v) for k, v in recs[0].items()}
    assert recs[1]["driver_exit"] == 0 and recs[1]["result_rows"] == recs[0]["result_rows"] > 0
    (run_id,) = os.listdir(tdir / "logs")
    with open(tdir / "logs" / run_id / "muscato_screen.log") as f:
        screen = f.read()
    assert screen.count("stage times [0,2000): host_stage=") == 1
    assert screen.count("stage sums over 1 batches: host_stage=") == 1


def _stale(kind, seq, ids, src):
    if kind == "empty":
        open(ids, "wb").close()
    elif kind == "older":
        t = os.stat(src).st_mtime_ns - 10**9
        os.utime(ids, ns=(t, t))
    elif kind == "missing":
        os.unlink(seq)


@pytest.mark.parametrize("kind", ["fresh", "empty", "older", "missing"])
def test_run_100m_prepares_stale_targets_again(small_data, tmp_path, kind, monkeypatch):
    """A prepared file that is missing, empty or older than genes.txt.sz
    makes the twin prepare the targets again (its run records the seconds);
    fresh files are reused ("cached"); the report files do not move."""
    from muscato_tpu_torch.io import targets

    monkeypatch.setenv("N_READS", "2000")
    d = tmp_path / "run"
    shutil.copytree(small_data, d)
    src = str(d / "genes.txt.sz")
    seq, ids = targets.prepared_names(src)
    targets.prep_targets(src)
    with open(ids, "rb") as f:
        ids_bytes = f.read()
    _stale(kind, seq, ids, src)
    assert run_100m._prepared_fresh(src, (seq, ids)) == (kind == "fresh")
    assert run_100m.main(["run", str(d), "--device", "cpu"]) == 0
    with open(d / "run100m.json") as f:
        rec = json.load(f)
    assert (rec["prep_targets_s"] == "cached") == (kind == "fresh")
    assert isinstance(rec["prep_targets_s"], str if kind == "fresh" else float)
    with open(ids, "rb") as f:
        assert f.read() == ids_bytes
    assert rec["driver_exit"] == 0 and rec["result_rows"] > 0


def test_run_100m_raises_without_a_card(tmp_path):
    """Asked for the card where there is none, the twin raises before it
    writes anything; it never runs on the CPU in its place."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        run_100m.main(["run", str(tmp_path / "none")])
    assert not (tmp_path / "none").exists()

