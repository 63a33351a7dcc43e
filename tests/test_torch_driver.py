"""The port's driver, CLI and report writers against the JAX package's on
the same inputs: results.txt, the nonmatch fastq, readstats and genestats
must be byte-identical.  Each package gets its own ReadSet, TargetSet and
Config."""

import dataclasses
import json
import os

import numpy as np
import pytest

from muscato_tpu import config as jconfig
from muscato_tpu.bench import gendat as jgendat
from muscato_tpu.engine import driver as jdriver
from muscato_tpu.engine import pipeline as jpipeline
from muscato_tpu.engine import report as jreport
from muscato_tpu_torch import cli
from muscato_tpu_torch import config as tconfig
from muscato_tpu_torch.bench import gendat as tgendat
from muscato_tpu_torch.io import targets
from muscato_tpu_torch.engine import driver as tdriver
from muscato_tpu_torch.engine import pipeline as tpipeline
from muscato_tpu_torch.engine import report as treport


def _outputs(results_path):
    """The four report files of one run, as bytes."""
    paths = (
        results_path,
        jreport.nonmatch_path(results_path),
        jreport._stats_path(results_path, "readstats"),
        jreport._stats_path(results_path, "genestats"),
    )
    out = []
    for p in paths:
        with open(p, "rb") as f:
            out.append(f.read())
    return out


@pytest.mark.parametrize("empty", [False, True])
def test_report_bytes_match_jax(tmp_path, empty):
    args = (800, 100, 40, 1000)
    rs, ts = tgendat.generate_arrays_realistic(*args, seed=2)
    jrs, jts = jgendat.generate_arrays_realistic(*args, seed=2)
    cfg = tconfig.Config(
        Windows=[10, 30, 50, 70], WindowWidth=20, PMatch=0.96, MinDinuc=3,
        MaxReadLength=200, MMTol=2, MaxMatches=10**6, MatchMode="best",
    )
    mr = tpipeline.run_matching(cfg, rs, ts, device="cpu")
    if empty:
        z = np.zeros(0, np.int32)
        mr = tpipeline.MatchResult(z, z, z, z)
    assert empty or len(mr.read_row) > 0
    jmr = jpipeline.MatchResult(mr.read_row, mr.gene, mr.start, mr.nmiss)
    for mod, name, m, r, t in ((treport, "t.txt", mr, rs, ts),
                               (jreport, "j.txt", jmr, jrs, jts)):
        path = str(tmp_path / name)
        table = mod.write_results(path, m, r, t)
        mod.write_nonmatch(path, m, r)
        mod.write_readstats(path, table)
        mod.write_genestats(path, table)
    assert _outputs(str(tmp_path / "t.txt")) == _outputs(str(tmp_path / "j.txt"))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("drv")
    reads, genes = tgendat.generate_big(
        3000, 100, 100, 1000, out_dir=str(d), seed=5, hit_frac=0.6
    )
    seq, ids = targets.prep_targets(genes, rev=False)
    return d, reads, seq, ids


def _cfg(files, tag, config=tconfig):
    d, reads, seq, ids = files
    return config.Config(
        ReadFileName=reads, GeneFileName=seq, GeneIdFileName=ids,
        ResultsFileName=str(d / f"{tag}.txt"), Windows=[10, 30, 50, 70],
        WindowWidth=20, PMatch=0.96, MinDinuc=3, MaxReadLength=200, MMTol=2,
        TempDir=str(d / f"tmp_{tag}"), LogDir=str(d / f"logs_{tag}"),
        Mesh="off",
    )


def test_driver_outputs_match_jax(files):
    """The JAX driver, then the port through its console entry point on
    the CPU, on files written by gendat and prepared by prep_targets."""
    d = files[0]
    jcfg = _cfg(files, "jax", config=jconfig)
    jconfig.apply_defaults(jcfg)
    jdriver.run(jcfg)

    tcfg = _cfg(files, "torch")
    cfg_path = d / "torch_config.json"
    with open(cfg_path, "w") as f:
        json.dump(dataclasses.asdict(tcfg), f)
    assert cli.main_muscato([f"-ConfigFileName={cfg_path}", "-device=cpu"]) == 0

    exp = _outputs(jcfg.ResultsFileName)
    got = _outputs(tcfg.ResultsFileName)
    assert exp[0].count(b"\n") > 100  # a real result set
    assert got == exp
    (logdir,) = os.listdir(d / "logs_torch")
    for name in ("config.json", "seqinfo.json", "muscato.log", "muscato_screen.log"):
        assert os.path.exists(d / "logs_torch" / logdir / name)
    assert os.listdir(d / "tmp_torch") == []  # TempDir cleaned up


@pytest.mark.parametrize(
    "field,value",
    [("IndexFile", "x.npz"), ("ResumeDir", "prev"), ("Mesh", "2x4"),
     ("Coordinator", "host:1")],
)
def test_driver_unported_options_raise(files, field, value):
    cfg = dataclasses.replace(_cfg(files, "unported"), **{field: value})
    with pytest.raises(NotImplementedError, match=field if field != "Coordinator" else "multi-host"):
        tdriver.run(cfg, device="cpu")


def test_cli_device_flag():
    assert cli._split_device(["-Windows=1", "-device=cpu"]) == (["-Windows=1"], "cpu")
    assert cli._split_device(["--device", "cuda:0", "-X=1"]) == (["-X=1"], "cuda:0")
    assert cli._split_device(["-WindowWidth=20"]) == (["-WindowWidth=20"], "cuda")
