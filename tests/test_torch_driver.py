"""The port's driver, CLI and report writers against the JAX package's on
the same inputs: results.txt, the nonmatch fastq, readstats and genestats
must be byte-identical, also for runs that load an index file or resume
from an earlier run's matches, written by either package.  Each package
gets its own ReadSet, TargetSet and Config."""

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
from native_codec import same_codec  # noqa: F401 (a fixture)


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


@pytest.fixture(scope="module")
def first_runs(files):
    """A JAX driver run that saves its index file and keeps its TempDir, and
    a port run on the CPU that does the same: per package the index file,
    the kept TempDir (with matches.npz) and the four report files' bytes."""
    d = files[0]
    out = {}
    for name, config, run in (("jax", jconfig, jdriver.run),
                              ("port", tconfig, lambda c: tdriver.run(c, device="cpu"))):
        cfg = _cfg(files, f"{name}_first", config=config)
        config.apply_defaults(cfg)
        cfg.NoCleanTemp = True
        cfg.IndexFile = str(d / f"{name}_index.npz")
        run(cfg)  # sets cfg.TempDir to the run's own directory
        assert os.path.exists(cfg.IndexFile)
        out[name] = dict(index=cfg.IndexFile, temp=cfg.TempDir,
                         reports=_outputs(cfg.ResultsFileName))
    assert out["port"]["reports"] == out["jax"]["reports"]
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_driver_index_file_matches_jax(files, first_runs, writer):
    """The port's driver loads an index file written by either package and
    writes the reports of the run that built it."""
    cfg = _cfg(files, f"index_from_{writer}")
    tconfig.apply_defaults(cfg)
    cfg.IndexFile = first_runs[writer]["index"]
    mtime = os.path.getmtime(cfg.IndexFile)
    tdriver.run(cfg, device="cpu")
    assert os.path.getmtime(cfg.IndexFile) == mtime  # loaded, not rewritten
    with open(os.path.join(cfg.LogDir, "muscato_index.log")) as f:
        assert "loaded index" in f.read()
    assert _outputs(cfg.ResultsFileName) == first_runs["jax"]["reports"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_driver_resume_matches_jax(files, first_runs, writer):
    """ResumeDir set to an earlier run's kept TempDir (its matches.npz
    written by either package) skips the matching and writes that run's
    reports."""
    cfg = _cfg(files, f"resume_from_{writer}")
    tconfig.apply_defaults(cfg)
    cfg.ResumeDir = first_runs[writer]["temp"]
    tdriver.run(cfg, device="cpu")
    with open(os.path.join(cfg.LogDir, "muscato.log")) as f:
        assert "resumed" in f.read()
    assert os.path.getsize(os.path.join(cfg.LogDir, "muscato_screen.log")) == 0
    assert _outputs(cfg.ResultsFileName) == first_runs["jax"]["reports"]


def test_driver_mesh_larger_than_world_raises(files):
    """A 2x4 mesh on a world of one process: the JAX message."""
    cfg = dataclasses.replace(_cfg(files, "mesh_2x4"), Mesh="2x4")
    with pytest.raises(ValueError, match="mesh 2x4 needs 8 devices, have 1"):
        tdriver.run(cfg, device="cpu")


def test_driver_malformed_mesh_exits_as_jax(files):
    cfg = dataclasses.replace(_cfg(files, "mesh_bad"), Mesh="2by4")
    with pytest.raises(SystemExit) as exp:
        jdriver._choose_mesh(dataclasses.replace(_cfg(files, "mesh_bad", config=jconfig),
                                                 Mesh="2by4"), 1000)
    with pytest.raises(SystemExit) as got:
        tdriver.run(cfg, device="cpu")
    assert str(got.value) == str(exp.value) == "Mesh must be 'auto', 'off', or 'DPxMP'; got '2by4'"


@pytest.mark.parametrize("mesh", ["off", "1x1"])
def test_driver_mesh_off_runs_single_device(files, first_runs, mesh):
    cfg = dataclasses.replace(_cfg(files, f"mesh_{mesh}"), Mesh=mesh)
    tconfig.apply_defaults(cfg)
    tdriver.run(cfg, device="cpu")
    with open(os.path.join(cfg.LogDir, "muscato.log")) as f:
        assert "mesh run" not in f.read()
    assert _outputs(cfg.ResultsFileName) == first_runs["jax"]["reports"]


def _files_of(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir()) if p.is_file()}


@pytest.mark.usefixtures("same_codec")
@pytest.mark.parametrize("rev", [False, True])
def test_cli_prep_targets_matches_jax(tmp_path, rev):
    """muscato_torch_prep_targets writes muscato_prep_targets' bytes."""
    from muscato_tpu import cli as jcli

    src = tgendat.generate_big(50, 100, 30, 500, out_dir=str(tmp_path), seed=3)[1]
    outs = []
    for name, main in (("jax", jcli.main_prep_targets), ("port", cli.main_prep_targets)):
        d = tmp_path / name
        d.mkdir()
        genes = d / os.path.basename(src)
        genes.write_bytes(open(src, "rb").read())
        assert main(["-rev", str(genes)] if rev else [str(genes)]) == 0
        outs.append(_files_of(d))
    assert len(outs[0]) == 3 and outs[1] == outs[0]


@pytest.mark.usefixtures("same_codec")
def test_cli_gendat_matches_jax(tmp_path):
    """muscato_torch_gendat writes muscato_gendat's bytes."""
    from muscato_tpu import cli as jcli

    args = ["-NumRead", "300", "-ReadLen", "60", "-NumGene", "20", "-GeneLen", "400",
            "-Seed", "7"]
    outs = []
    for name, main in (("jax", jcli.main_gendat), ("port", cli.main_gendat)):
        d = tmp_path / name
        d.mkdir()
        assert main(args + ["-Dir", str(d)]) == 0
        outs.append(_files_of(d))
    assert len(outs[0]) >= 2 and outs[1] == outs[0]


def test_cli_device_flag():
    assert cli._split_device(["-Windows=1", "-device=cpu"]) == (["-Windows=1"], "cpu")
    assert cli._split_device(["--device", "cuda:0", "-X=1"]) == (["-X=1"], "cuda:0")
    assert cli._split_device(["-WindowWidth=20"]) == (["-WindowWidth=20"], "cuda")
