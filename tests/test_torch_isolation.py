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


def test_scan_covers_every_port_module():
    """The scan finds its files by itself: the search probe's module, the
    mesh's modules, the plain references and every bench tool are among
    them."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"muscato_tpu_torch/ops/search.py", "muscato_tpu_torch/bench/runner.py",
            "muscato_tpu_torch/engine/pipeline.py", "muscato_tpu_torch/parallel/mesh.py",
            "muscato_tpu_torch/parallel/dist.py", "muscato_tpu_torch/ops/verify.py",
            "muscato_tpu_torch/ops/windows.py", "muscato_tpu_torch/scripts/gen_parallel.py",
            "muscato_tpu_torch/scripts/run_100m.py", "chip_smoke.py"} <= names
    assert {f"muscato_tpu_torch/bench/{t}.py" for t in (
        "scaling", "engine_device_check", "pallas_device_check", "profile_match",
        "micro_verify", "bigtest", "prep_rss")} <= names


# Modules of the JAX package with no module at the same path in the port,
# each with its reason.
NOT_PORTED = {
    "ops/pallas_join.py": "B1: ported as csrc/join.cu and its wrapper ops/join.py",
    "ops/pallas_expand.py": "B2 and B6: ported as csrc/expand.cu and ops/expand.py",
    "ops/pallas_gather.py": "B3 and B4: ported as csrc/gather.cu and ops/gather.py",
    "ops/pallas_windows.py": "B5: ported as csrc/windows.cu and ops/window_queries.py",
    "bench/micro_r2.py": "the TPU probe design's sort and gather microbenchmarks (lax.sort)",
    "bench/probe_ab.py": "a TPU probe A/B; chip_smoke.py times the port's probes by batch size",
    "bench/dedup_ab.py": "a TPU dedup-or-streaming A/B; chip_smoke.py runs both flagship paths",
    "bench/mesh_sanity.py": "chip_smoke.mesh_one_phase is its twin",
}


def test_every_jax_module_has_a_counterpart():
    """Module parity: each module of muscato_tpu has a module at the same
    relative path in muscato_tpu_torch, except the list above, and the
    list names only modules that exist and are not ported."""
    jax_mods = {str(p.relative_to(ROOT / "muscato_tpu"))
                for p in (ROOT / "muscato_tpu").rglob("*.py")}
    port_mods = {str(p.relative_to(ROOT / "muscato_tpu_torch"))
                 for p in (ROOT / "muscato_tpu_torch").rglob("*.py")}
    assert sorted(jax_mods - port_mods - set(NOT_PORTED)) == []
    assert set(NOT_PORTED) <= jax_mods - port_mods


# Scripts of the repo's scripts/ with no twin in muscato_tpu_torch/scripts/,
# each with its reason (ROADMAP.md, "Do not port").
_LADDER = ("the TUNED.json autotune ladder: it tunes the TPU's switches and "
           "Pallas windows, which the port does not have")
_RELAY = "a relay queue of TPU measurements; the port measures in chip_smoke.py"
NOT_PORTED_SCRIPTS = {
    "autotune_r3.py": _LADDER,
    "tune_finish.py": _LADDER,
    "run_ladder_steps.py": _LADDER,
    "round4_post.py": _LADDER,
    "round5_queue.py": _RELAY,
    "round5_queue2.py": _RELAY,
    "round5_queue3.py": _RELAY,
    "round5_queue4.py": _RELAY,
}


def test_every_script_has_a_counterpart():
    """Script parity: each scripts/*.py has a module of the same name in
    muscato_tpu_torch/scripts/, except the list above, which names only
    scripts that exist and are not ported."""
    scripts = {p.name for p in (ROOT / "scripts").glob("*.py")}
    twins = {p.name for p in (ROOT / "muscato_tpu_torch" / "scripts").glob("*.py")}
    assert sorted(scripts - twins - set(NOT_PORTED_SCRIPTS)) == []
    assert set(NOT_PORTED_SCRIPTS) <= scripts - twins
    assert {"gen_parallel.py", "run_100m.py"} <= twins


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
