"""The port against the JAX package on every setting of the config matrix
(muscato_tpu_torch/bench/config_matrix.py) beyond the flagship's: the
reference's test setting at width 4 (also through both command lines on
reverse-complement targets, with reads from both strands), its documented flags at width 15, ``first``
mode with a MaxMatches cap that binds within and across read batches, the
widest exact width, widths 32 and 40, 66 windows (the streaming expand),
and reads of 2,000 and 8,000 bases (the latter also through the streaming
expand).  Each case runs at its small size on the same
``generate_arrays_realistic`` workload in both packages; the
MatchResult's (read_row, gene, start, nmiss) must be equal, with at least
one match.  The port runs on the CPU, so its kernels' plain twins run;
the JAX package runs as its own tests run it (the conftest keeps it on
the CPU and its XLA paths).

Then B5's window groups: the wrapper's launches of at most 64 windows,
each at its offset in the outputs, with the launch stubbed by the twin,
give the twin's outputs at 1, 64, 65 and 130 windows.
"""

import ctypes
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from muscato_tpu import cli as jcli
from muscato_tpu import config as jconfig
from muscato_tpu.bench import gendat as jgendat
from muscato_tpu.engine import driver as jdriver
from muscato_tpu.engine import pipeline as jpipeline
from muscato_tpu_torch import cli
from muscato_tpu_torch.bench import config_matrix as cm
from muscato_tpu_torch.bench import engine_device_check as edc
from muscato_tpu_torch.bench import gendat as tgendat
from muscato_tpu_torch.engine import pipeline as tpipeline
from muscato_tpu_torch.io import sz, targets
from muscato_tpu_torch.ops import window_queries as wq
from test_torch_driver import _outputs
from test_torch_windows_cuda import _reads


def _cli_reports(name, tmp_path):
    """The case's reads and genes written as files; each package's
    prep_targets with -rev, then its driver (the JAX driver, and the port
    through muscato_torch on the CPU): both runs' four report files."""
    case = cm.CASES[name]
    src = tmp_path / "src"
    src.mkdir()
    reads, genes = cm.write_files(*tgendat.generate_arrays_realistic(*case.small, seed=0),
                                  str(src))
    out = {}
    for pkg, prep, config in (("jax", jcli.main_prep_targets, jconfig),
                              ("port", cli.main_prep_targets, None)):
        d = tmp_path / pkg
        d.mkdir()
        assert prep(["-rev", shutil.copy(genes, d)]) == 0
        seq, ids = targets.prepared_names(str(d / os.path.basename(genes)))
        cfg = dataclasses.replace(
            cm.config(name, small=True), ReadFileName=reads, GeneFileName=seq,
            GeneIdFileName=ids, ResultsFileName=str(d / "results.txt"),
            TempDir=str(d / "tmp"), LogDir=str(d / "logs"), Mesh="off")
        if config is not None:
            jcfg = config.Config(**dataclasses.asdict(cfg))
            config.apply_defaults(jcfg)
            jdriver.run(jcfg)
        else:
            with open(d / "config.json", "w") as f:
                json.dump(dataclasses.asdict(cfg), f)
            assert cli.main_muscato([f"-ConfigFileName={d / 'config.json'}",
                                     "-device=cpu"]) == 0
        out[pkg] = _outputs(cfg.ResultsFileName)
    # Each gene and its reverse complement (_r) are targets.
    assert sz.read_bytes(ids).count(b"_r\t") == case.small[2]
    return out


@pytest.mark.parametrize("name", list(cm.CASES))
def test_config_matches_jax(name, tmp_path):
    case = cm.CASES[name]
    if case.rev:
        out = _cli_reports(name, tmp_path)
        rows = out["jax"][0].splitlines()
        assert any(b"_r\t" in ln for ln in rows) and any(b"_r\t" not in ln for ln in rows)
        assert out["port"] == out["jax"]
        return
    rs, ts = tgendat.generate_arrays_realistic(*case.small, seed=0)
    jrs, jts = jgendat.generate_arrays_realistic(*case.small, seed=0)
    cfg = cm.config(name, small=True)
    index = tpipeline.build_target_index(ts, cfg.WindowWidth, "cpu")
    for path in case.paths:
        pcfg = dataclasses.replace(cfg, **edc.PATHS[path][1])
        got = tpipeline.run_matching_indexed(pcfg, rs, index)
        exp = jpipeline.run_matching(jconfig.Config(**dataclasses.asdict(pcfg)), jrs, jts)
        assert len(exp.read_row) > 0, path
        for f in ("read_row", "gene", "start", "nmiss"):
            np.testing.assert_array_equal(getattr(got, f), getattr(exp, f),
                                          err_msg=f"{path}: {f}")


def test_config_cases_reach_their_branches():
    """The matrix holds what it is for: widths 4-40 on both sides of the
    exact-key limit, more than 64 windows, a first-mode cap, reads of
    8,000 bases through both expands, and the -rev command-line run."""
    widths = {cm.config(n).WindowWidth for n in cm.CASES}
    assert {4, 13, 15, 32, 40} <= widths
    assert max(len(cm.config(n).Windows) for n in cm.CASES) > wq.MAX_WINDOWS
    first = cm.config("first-w10-capped")
    assert first.MatchMode == "first" and first.MaxMatches == 2
    assert cm.CASES["first-w10-capped"].data[0] > 2 * first.ReadBatch
    assert cm.CASES["long-8k"].paths == ("auto", "NoDedup")
    assert cm.CASES["long-8k"].data[1] > 8 * 907  # past B10's (and B7's) staged tile
    assert [n for n, c in cm.CASES.items() if c.rev] == ["golden-w4-rev"]


@pytest.mark.parametrize("nwin", [1, 64, 65, 130])
def test_window_groups_match_twin(nwin, monkeypatch):
    """B5's launches of at most MAX_WINDOWS windows: each launch's window
    table holds the windows that start at its output offset (k0 * R rows
    into key1, key2 and valid); a stub that writes the twin's outputs for
    that table at those addresses gives the twin's outputs for all the
    windows."""
    rp, ln = _reads(301, 296, nwin)
    nreads, nw = rp.shape
    q1s = tuple(range(0, 2 * nwin, 2))
    width, min_dinuc = 20, 3
    out = (torch.full((nwin * nreads,), -7, dtype=torch.int32),
           torch.full((nwin * nreads,), -7, dtype=torch.int32),
           torch.zeros(nwin * nreads, dtype=torch.bool))
    groups = []

    def launch(name, like, rp_ptr, ln_ptr, n, nw_, params, ngroup, w, md, m1, m2, k2,
               *ptrs):
        assert (name, rp_ptr, ln_ptr, n, nw_, w, md) == (
            "window_queries", rp.data_ptr(), ln.data_ptr(), nreads, nw, width, min_dinuc)
        k0 = (ptrs[0] - out[0].data_ptr()) // (4 * nreads)
        assert ptrs == (out[0].data_ptr() + 4 * k0 * nreads,
                        out[1].data_ptr() + 4 * k0 * nreads, out[2].data_ptr() + k0 * nreads)
        table = list((ctypes.c_longlong * (3 * ngroup)).from_address(params))
        group = q1s[k0:k0 + ngroup]
        assert table == wq._window_table(nw, group, width)
        groups.append((k0, ngroup))
        for ptr, x in zip(ptrs, wq.window_queries_torch(rp, ln, group, width=w,
                                                        min_dinuc=md)):
            ctypes.memmove(ptr, x.data_ptr(), x.numel() * x.element_size())

    monkeypatch.setattr(wq._lib, "launch", launch)
    before = wq.window_queries.launches
    wq._launch_groups(rp, ln, q1s, width, min_dinuc, *out)
    starts = list(range(0, nwin, wq.MAX_WINDOWS))
    assert groups == [(k0, min(wq.MAX_WINDOWS, nwin - k0)) for k0 in starts]
    assert wq.window_queries.launches == before + len(starts)
    for name, a, b in zip(("key1", "key2", "valid"), out,
                          wq.window_queries_torch(rp, ln, q1s, width=width,
                                                  min_dinuc=min_dinuc)):
        assert torch.equal(a, b), name
