"""The port stands alone: no file of muscato_tpu_torch and not chip_smoke.py
imports jax or any module of muscato_tpu (here, by scanning the sources;
tests/test_torch_ops.py::test_port_imports_no_jax imports them all in a
fresh interpreter), and the port's copies of the JAX package's host layer
(config, io, bench.gendat) behave as the originals do on the same
inputs."""

import ast
import dataclasses
import filecmp
import gzip
import io
import pathlib
import shutil

import numpy as np
import pytest

from muscato_tpu import config as jconfig
from muscato_tpu.bench import gendat as jgendat
from muscato_tpu.io import reads as jreads
from muscato_tpu.io import targets as jtargets
from muscato_tpu_torch import config as tconfig
from muscato_tpu_torch.bench import gendat as tgendat
from muscato_tpu_torch.io import reads as treads
from muscato_tpu_torch.io import targets as ttargets

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "muscato_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    return any(module == p or module.startswith(p + ".") for p in ("jax", "muscato_tpu"))


def _imports(path: pathlib.Path):
    """Absolute module names imported anywhere in the file, including inside
    functions; relative imports are inside the port by construction."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_nothing_of_jax_package(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize(
    "argv",
    [
        ["-ReadFileName=r.fq", "-GeneFileName=g.txt.sz", "-GeneIdFileName=ids.txt.sz",
         "-Windows=10,30,50,70", "-WindowWidth=20", "-PMatch=0.96", "-MinDinuc=3",
         "-MaxReadLength=200"],
        ["--ReadFileName=r.fq", "--GeneFileName=g", "--GeneIdFileName=i",
         "--Windows=0,20", "--WindowWidth=10", "--MaxReadLength=120",
         "--MatchMode=first", "--MaxMatches=2", "--NoDedup", "--MMTol=0",
         "--ReadBatch=2048"],
        ["-ReadFileName=r.fq", "-GeneFileName=g", "-GeneIdFileName=i",
         "-Windows=5", "-WindowWidth=12", "-NoCleanTemp", "-MaxReadLength=150"],
    ],
    ids=["flagship", "first-nodedup", "defaults"],
)
def test_config_copy_matches_jax(argv):
    """parse_cli then apply_defaults give equal configs, and the same
    JSON, in both packages."""
    j, t = jconfig.parse_cli(argv), tconfig.parse_cli(argv)
    jerr, terr = io.StringIO(), io.StringIO()
    jconfig.apply_defaults(j, stderr=jerr)
    tconfig.apply_defaults(t, stderr=terr)
    assert terr.getvalue() == jerr.getvalue()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.to_json() == j.to_json()


def test_config_copy_rejects_as_jax_does():
    errs = []
    for mod in (jconfig, tconfig):
        errs.append(io.StringIO())
        with pytest.raises(SystemExit):
            mod.apply_defaults(mod.parse_cli(["-GeneFileName=g"]), stderr=errs[-1])
    assert errs[1].getvalue() == errs[0].getvalue() != ""


def _gene_files(tmp_path, fmt):
    """One raw gene file in the format ``fmt``, copied into jax/ and port/
    subdirectories (prep_targets writes its outputs beside its input)."""
    src = tmp_path / "src"
    src.mkdir()
    _, genes = jgendat.generate(20, 50, 30, 300, out_dir=str(src), seed=7)
    if fmt != "sz":
        from muscato_tpu.io import sz

        text = sz.read_bytes(genes)
        if fmt == "fasta":
            text = b"".join(
                b">" + name + b"\n" + seq + b"\n"
                for name, seq in (line.split(b"\t") for line in text.splitlines())
            )
        name = {"txt": "genes.txt", "gz": "genes.txt.gz", "fasta": "genes.fasta"}[fmt]
        genes = str(src / name)
        with (gzip.open if fmt == "gz" else open)(genes, "wb") as f:
            f.write(text)
    out = []
    for sub in ("jax", "port"):
        (tmp_path / sub).mkdir()
        out.append(shutil.copy(genes, tmp_path / sub))
    return out


@pytest.mark.parametrize("rev", [False, True])
@pytest.mark.parametrize("fmt", ["sz", "txt", "gz", "fasta"])
def test_prep_targets_copy_matches_jax(tmp_path, fmt, rev):
    """prep_targets writes the same bytes, and load_targets reads the same
    TargetSet, in both packages."""
    jin, tin = _gene_files(tmp_path, fmt)
    jout = jtargets.prep_targets(jin, rev=rev)
    tout = ttargets.prep_targets(tin, rev=rev)
    for a, b in zip(jout, tout):
        assert filecmp.cmp(a, b, shallow=False), (a, b)
    jts, tts = jtargets.load_targets(*jout), ttargets.load_targets(*tout)
    np.testing.assert_array_equal(tts.tcat, jts.tcat)
    np.testing.assert_array_equal(tts.gene_start, jts.gene_start)
    assert tts.num_genes == jts.num_genes > 0


@pytest.mark.parametrize("fn", ["generate_arrays_realistic", "generate_arrays"])
def test_gendat_arrays_copy_matches_jax(fn):
    args = (3000, 100, 50, 1000)
    jrs, jts = getattr(jgendat, fn)(*args, seed=11)
    trs, tts = getattr(tgendat, fn)(*args, seed=11)
    assert isinstance(trs, treads.ReadSet) and isinstance(tts, ttargets.TargetSet)
    for f in ("codes", "lengths", "counts"):
        np.testing.assert_array_equal(getattr(trs, f), getattr(jrs, f))
    assert (trs.num_unique, trs.num_total) == (jrs.num_unique, jrs.num_total)
    np.testing.assert_array_equal(tts.tcat, jts.tcat)
    np.testing.assert_array_equal(tts.gene_start, jts.gene_start)


@pytest.mark.parametrize("fn", ["generate", "generate_big"])
def test_gendat_files_copy_match_jax(tmp_path, fn):
    """Files written from one seed are byte-identical, and the port's
    build_readset reads them as the JAX package's does."""
    outs = []
    for sub, mod in (("jax", jgendat), ("port", tgendat)):
        d = tmp_path / sub
        d.mkdir()
        outs.append(getattr(mod, fn)(400, 60, 20, 500, out_dir=str(d), seed=4))
    for a, b in zip(*outs):
        assert filecmp.cmp(a, b, shallow=False), (a, b)
    jrs = jreads.build_readset(outs[0][0], 0, 200)
    trs = treads.build_readset(outs[1][0], 0, 200)
    np.testing.assert_array_equal(trs.codes, jrs.codes)
    np.testing.assert_array_equal(trs.counts, jrs.counts)
    assert trs.names == jrs.names
