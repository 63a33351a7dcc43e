"""Two processes of the port on the CPU (tests/torch_mh_worker.py), the
twin of tests/test_multihost.py.

Each process joins a gloo world through ``dist.initialize`` and builds the
ReadSet of a fastq file with ``build_readset_multihost``, which must equal
``build_readset`` of the whole file.  Then each runs the ``muscato_torch``
entry point with Coordinator/ProcessCount/ProcessIndex on the CPU, twice:
Mesh=1x2 (two index shards) and Mesh=2x1 (read parallelism, each rank
indexing every gene).  In each world rank 0's four report files must be
byte-identical to the JAX package's single-process driver's on the same
files, rank 1 writes none, and every rank parses its own byte range of
the read file.  Besides: the mesh the driver's auto rule takes against the
JAX driver's, and the probes past PACKED_LO_LIMIT index windows (the int64
compaction key a mesh shard of 2^30-1.5e9 windows takes) against the JAX
engine's run.
"""

import dataclasses
import json
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax
import torch

from muscato_tpu import config as jconfig
from muscato_tpu.bench import gendat as jgendat
from muscato_tpu.engine import driver as jdriver
from muscato_tpu.engine import pipeline as jpipeline
from muscato_tpu.engine import report as jreport
from muscato_tpu.parallel import mesh as jmesh
from muscato_tpu_torch import config as tconfig
from muscato_tpu_torch.bench import gendat
from muscato_tpu_torch.engine import driver as tdriver
from muscato_tpu_torch.engine import pipeline as tpipeline
from muscato_tpu_torch.io import targets
from muscato_tpu_torch.ops import fused
from muscato_tpu_torch.parallel import mesh as tmesh

HERE = os.path.dirname(os.path.abspath(__file__))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _outputs(results_path):
    """The four report files of one run, as bytes."""
    out = []
    for p in (results_path, jreport.nonmatch_path(results_path),
              jreport._stats_path(results_path, "readstats"),
              jreport._stats_path(results_path, "genestats")):
        with open(p, "rb") as f:
            out.append(f.read())
    return out


def _cfg(d, tag, reads, seq, ids, config=tconfig, **fields):
    return config.Config(
        ReadFileName=reads, GeneFileName=seq, GeneIdFileName=ids,
        ResultsFileName=str(d / f"{tag}.txt"), Windows=[10, 30, 50, 70],
        WindowWidth=20, PMatch=0.96, MinDinuc=3, MaxReadLength=200, MMTol=2,
        TempDir=str(d / f"tmp_{tag}"), LogDir=str(d / f"logs_{tag}"), **fields,
    )


# (config tag, Mesh, report and log name prefix) of each world the workers run.
WORLDS = (("mp", "1x2", "rank"), ("dp", "2x1", "dp_rank"))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Inputs written, both workers run to their end, and the JAX driver's
    single-process run on the same files: (directory, each worker's exit
    code and output)."""
    d = tmp_path_factory.mktemp("mh")
    g = np.random.default_rng(5)
    recs = []
    for i in range(200):
        seq = "".join("ACGT"[c] for c in g.integers(0, 4, 30))
        recs.append(f"@mh{i % 37:03d}\n{seq}\n+\n{'I' * 30}")
    (d / "mh_reads.fastq").write_text("\n".join(recs) + "\n")
    reads, genes = gendat.generate_big(3000, 100, 100, 1000, out_dir=str(d), seed=5,
                                       hit_frac=0.6)
    seq, ids = targets.prep_targets(genes, rev=False)
    for tag, mesh, prefix in WORLDS:
        port2 = _free_port()
        for pid in range(2):
            cfg = _cfg(d, f"{prefix}{pid}", reads, seq, ids, Mesh=mesh,
                       Coordinator=f"localhost:{port2}", ProcessCount=2,
                       ProcessIndex=str(pid))
            with open(d / f"config_{tag}_{pid}.json", "w") as f:
                json.dump(dataclasses.asdict(cfg), f)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_mh_worker.py"), str(pid), "2",
         str(port), str(d), *(tag for tag, _, _ in WORLDS)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for pid in range(2)]
    try:
        jcfg = _cfg(d, "jax", reads, seq, ids, config=jconfig, Mesh="off")
        jconfig.apply_defaults(jcfg)
        jdriver.run(jcfg)
        outs = [p.communicate(timeout=300)[0].decode(errors="replace") for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return d, [(p.returncode, out) for p, out in zip(procs, outs)]


def test_two_processes_build_the_readset_and_run(run):
    _, results = run
    for pid, (rc, out) in enumerate(results):
        assert rc == 0 and f"worker {pid} OK" in out, out[-4000:]


def test_rank0_reports_match_jax_driver(run):
    d, _ = run
    got = _outputs(str(d / "rank0.txt"))
    assert got == _outputs(str(d / "jax.txt"))
    assert got[0].count(b"\n") > 100  # a real result set
    (logdir,) = os.listdir(d / "logs_rank0")
    with open(d / "logs_rank0" / logdir / "muscato.log") as f:
        log = f.read()
    assert "mesh run: dp=1 mp=2, rank 0" in log and "rank 0 of 2 (gloo)" in log


def test_rank1_writes_no_report(run):
    d, _ = run
    assert not (d / "rank1.txt").exists()
    (logdir,) = os.listdir(d / "logs_rank1")
    with open(d / "logs_rank1" / logdir / "muscato.log") as f:
        assert "non-primary process" in f.read()


def _main_log(d, prefix, pid):
    (logdir,) = os.listdir(d / f"logs_{prefix}{pid}")
    with open(d / f"logs_{prefix}{pid}" / logdir / "muscato.log") as f:
        return f.read()


def test_dp_world_rank0_reports_match_jax_driver(run):
    d, _ = run
    got = _outputs(str(d / "dp_rank0.txt"))
    assert got == _outputs(str(d / "jax.txt"))
    log = _main_log(d, "dp_rank", 0)
    assert "mesh run: dp=2 mp=1, rank 0" in log and "rank 0 of 2 (gloo)" in log


def test_dp_world_rank1_writes_no_report(run):
    d, _ = run
    assert not (d / "dp_rank1.txt").exists()
    assert "non-primary process" in _main_log(d, "dp_rank", 1)


@pytest.mark.parametrize("prefix", [p for _, _, p in WORLDS])
@pytest.mark.parametrize("pid", [0, 1])
def test_each_rank_parses_its_byte_range(run, prefix, pid):
    """The driver's range-sharded read prep: each rank logs its own half
    of the read file's bytes, and the two halves' reads make the whole."""
    d, _ = run
    with open(d / "config_mp_0.json") as f:
        size = os.path.getsize(json.load(f)["ReadFileName"])
    lines = [re.search(r"range-sharded read prep: rank (\d) of 2 parsed bytes "
                       r"\[(\d+),(\d+)\) of (\d+): (\d+) reads", _main_log(d, prefix, p))
             for p in (0, 1)]
    assert [int(x) for x in lines[pid].groups()[:4]] == [
        pid, pid * size // 2, (pid + 1) * size // 2, size]
    assert sum(int(m.group(5)) for m in lines) == 3000


@pytest.mark.parametrize("world", range(1, 9))
def test_choose_mesh_matches_jax(monkeypatch, world):
    """The driver's mesh for ``world`` processes (the port) and devices (the
    JAX package) at 1e8-6.5e9 bases: the same (dp, mp), or None for both,
    under Mesh auto, its empty default, and off."""
    got = {}
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: world)
    monkeypatch.setattr(tmesh, "make_mesh", lambda dp, mp, device="cuda": ("port", dp, mp))
    monkeypatch.setattr(jax, "devices", lambda *a: [object()] * world)
    monkeypatch.setattr(jmesh, "make_mesh", lambda dp, mp, *a, **k: ("jax", dp, mp))
    for spec in ("auto", "", "off"):
        for n in (1e8, 1e9, 1.5e9, 1.5e9 + 1, 2.4e9, 3e9, 3e9 + 1, 4.5e9, 6e9, 6.5e9):
            p = tdriver._choose_mesh(tconfig.Config(Mesh=spec), int(n), "cpu")
            j = jdriver._choose_mesh(jconfig.Config(Mesh=spec), int(n))
            got[spec, n] = p and p[1:]
            assert (p and p[1:]) == (j and j[1:]), (spec, n)
    assert got["auto", 1e8] == (None if world == 1 else (world, 1))
    assert got["off", 6.5e9] is None


@pytest.mark.parametrize("pjoin", ["1", "0"])
def test_probe_past_packed_lo_limit_matches_jax(monkeypatch, pjoin):
    """A mesh shard of 2^30 to 1.5e9 windows (the driver's auto mesh takes
    one past 2^31-1 bases in two) passes the (inactive, lo) key's 30 bits:
    the probes, sorted join and sort-merge, then sort an int64 key.  With
    PACKED_LO_LIMIT lowered below this index's windows, each probe's
    compaction equals the int32 one's, and the whole run equals the JAX
    engine's (whose probes take the int32 key)."""
    monkeypatch.setenv("MUSCATO_PJOIN", pjoin)
    args = (3000, 100, 200, 1000)
    rs, ts = gendat.generate_arrays_realistic(*args, seed=4)
    cfg = tconfig.Config(Windows=[10, 30, 50, 70], WindowWidth=20, PMatch=0.96, MinDinuc=3,
                         MaxReadLength=200, MMTol=2, MaxMatches=10**6)
    index = tpipeline.build_target_index(ts, cfg.WindowWidth, "cpu")
    rpacked, lengths = tpipeline._upload_rows(rs.codes, rs.lengths, rs.codes.shape[0],
                                              torch.device("cpu"), None)
    probe = fused._probe_windows_pjoin_impl if pjoin == "1" else fused._probe_windows_impl
    narrow = probe(rpacked, lengths, tuple(cfg.Windows), index.skeys, width=20, min_dinuc=3)
    monkeypatch.setattr(fused, "PACKED_LO_LIMIT", 1 << 10)
    assert index.skeys.shape[0] > fused.PACKED_LO_LIMIT
    wide = probe(rpacked, lengths, tuple(cfg.Windows), index.skeys, width=20, min_dinuc=3)
    assert wide.lo.dtype == narrow.lo.dtype == torch.int32
    for f in ("counts", "lo"):
        np.testing.assert_array_equal(getattr(wide, f).numpy(), getattr(narrow, f).numpy())
    triples = [sorted(zip(*(getattr(pr, f).tolist() for f in ("qid", "lo", "counts"))))
               for pr in (wide, narrow)]
    assert triples[0] == triples[1] and int(wide.total) == int(narrow.total) > 0
    got = tpipeline.run_matching(cfg, rs, ts, device="cpu")
    exp = jpipeline.run_matching(jconfig.Config(**dataclasses.asdict(cfg)),
                                 *jgendat.generate_arrays_realistic(*args, seed=4))
    assert len(exp.read_row) > 0
    for f in ("read_row", "gene", "start", "nmiss"):
        np.testing.assert_array_equal(getattr(got, f), getattr(exp, f), err_msg=f)
