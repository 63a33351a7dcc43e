"""Two processes of the port on the CPU (tests/torch_mh_worker.py), the
twin of tests/test_multihost.py.

Each process joins a gloo world through ``dist.initialize`` and builds the
ReadSet of a fastq file with ``build_readset_multihost``, which must equal
``build_readset`` of the whole file.  Then each runs the ``muscato_torch``
entry point with Coordinator/ProcessCount/ProcessIndex and Mesh=1x2 on
the CPU: rank 0's four report files must be byte-identical to the JAX
package's single-process driver's on the same files, and rank 1 writes
none.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from muscato_tpu import config as jconfig
from muscato_tpu.engine import driver as jdriver
from muscato_tpu.engine import report as jreport
from muscato_tpu_torch import config as tconfig
from muscato_tpu_torch.bench import gendat
from muscato_tpu_torch.io import targets

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
    port2 = _free_port()
    for pid in range(2):
        cfg = _cfg(d, f"rank{pid}", reads, seq, ids, Mesh="1x2",
                   Coordinator=f"localhost:{port2}", ProcessCount=2, ProcessIndex=str(pid))
        with open(d / f"config_{pid}.json", "w") as f:
            json.dump(dataclasses.asdict(cfg), f)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_mh_worker.py"), str(pid), "2",
         str(port), str(port2), str(d)],
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
