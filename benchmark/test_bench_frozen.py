"""The benchmark's frozen copies against their originals at a small size:
the work and bound arithmetic against chip_smoke.py's, the traffic
generator against gendat's distributions."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark.bench_testing import HERE, ROOT
from benchmark.harness import profiling, reference, traffic, work


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_for_bench",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _recorded(cfg_over: dict, probe=None, monkeypatch=None):
    """The kernel calls of a small match on the CPU."""
    from muscato_tpu_torch.config import Config
    from muscato_tpu_torch.engine import pipeline
    from muscato_tpu_torch.engine.index import build_target_index
    from muscato_tpu_torch.io.reads import ReadSet
    from muscato_tpu_torch.io.targets import TargetSet

    with open(os.path.join(HERE, "configs", "bigtest-w20.json")) as f:
        cfg = {**json.load(f)["config"], **cfg_over}
    mix = dict(reads_per_call=3000, shift_span=0, frac_random=0.1, sub_rate=0.02)
    genes, gs, codes = traffic.make_cell_data({"count": 100, "length": 1000}, 100, mix, 11,
                                              "cpu")
    ts = TargetSet(tcat=genes.numpy(), gene_start=gs, names=[], lengths=np.diff(gs))
    index = build_target_index(ts, cfg["WindowWidth"], "cpu", device_build=True)
    rs = ReadSet(codes=codes, lengths=np.full(len(codes), 100, np.int32),
                 counts=np.ones(len(codes), np.int64), num_total=len(codes))
    with profiling.recorded_calls(plain=True) as calls:
        pipeline.run_matching_indexed(Config(**cfg), rs, index, probe=probe)
    return list(calls)


@pytest.mark.parametrize("case", ["default", "search-direct", "search-binary", "streaming"])
def test_call_work_matches_chip_smoke(case, monkeypatch):
    cs = _chip_smoke()
    over, probe = {}, None
    if case.startswith("search"):
        probe = "search"
        if case == "search-binary":
            from muscato_tpu_torch.engine import index as index_mod

            monkeypatch.setattr(index_mod, "MAX_DIRECT_BITS", 10)
    if case == "streaming":
        over = {"NoDedup": True}
    calls = _recorded(over, probe)
    kinds = {c["kernel"] for c in calls}
    want = {"default": {"window_queries", "sorted_join", "expand_owners", "monotone_gather",
                        "monotone_gather_rows", "verify_diagonals_swar"},
            "search-direct": {"direct_probe"}, "search-binary": {"binary_probe"},
            "streaming": {"verify_pairs"}}[case]
    assert want <= kinds
    for c in calls:
        assert work.call_work(c["kernel"], c["args"], c["kw"]) == cs.call_work(
            c["kernel"], c["args"], c["kw"]), c["kernel"]


def test_bounds_match_chip_smoke(monkeypatch):
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "int_pipe_rate", lambda: 1.7e13)
    for w in ((10**9, 0, 10**6), (10**6, 10**9, 10**8), (0, 5, 7)):
        assert work.bounds(w, int_rate=1.7e13) == cs.bounds(w)


def _shares(genes, gene_start, codes):
    ref = reference.Reference(genes, gene_start, windows=[10, 30, 50, 70], width=20, pmatch=0.96,
                              min_dinuc=3, max_read_length=200, mmtol=2, max_matches=10**6,
                              match_mode="best")
    rows = ref.match(torch.from_numpy(codes), torch.full((len(codes),), 100, dtype=torch.int32)).numpy()
    best = {}
    for r, nx in rows[:, [0, 3]]:
        best[r] = min(best.get(r, 99), nx)
    nx = np.array(list(best.values()))
    return len(best) / len(codes), nx.mean(), np.bincount(codes.ravel(), minlength=4) / codes.size


@pytest.mark.parametrize("frac_random", [0.1, 0.9])
def test_traffic_matches_gendat(frac_random):
    from muscato_tpu_torch.bench import gendat

    n, count, length = 20000, 300, 1000
    rs, ts = gendat.generate_arrays_realistic(n, 100, count, length, seed=3,
                                              frac_random=frac_random)
    mix = dict(reads_per_call=n, shift_span=0, frac_random=frac_random, sub_rate=0.02)
    genes, gs, codes = traffic.make_cell_data({"count": count, "length": length}, 100, mix, 3,
                                              "cpu")
    rows = [r.tobytes() for r in codes]
    assert rows == sorted(set(rows))  # distinct, in read prep's order
    ours = _shares(genes, gs, codes)
    theirs = _shares(torch.from_numpy(np.asarray(ts.tcat)), np.asarray(ts.gene_start), rs.codes)
    assert abs(len(codes) - rs.num_unique) <= n // 200
    assert abs(ours[0] - theirs[0]) < 0.02  # the share of reads that match
    assert abs(ours[1] - theirs[1]) < 0.1  # the mean of their least mismatches
    np.testing.assert_allclose(ours[2], theirs[2], atol=0.01)  # base frequencies


def _planted_rows(genes, gene_start, codes):
    """The reference's rows at bigtest's flags (exact matches)."""
    ref = reference.Reference(genes, gene_start, windows=[10, 30, 50, 70], width=20, pmatch=1.0,
                              min_dinuc=0, max_read_length=200, mmtol=0, max_matches=10**6,
                              match_mode="best")
    return ref.match(torch.from_numpy(codes),
                     torch.full((len(codes),), 100, dtype=torch.int32)).numpy()


def test_gendat_traffic_matches_gendat():
    """The ``gendat`` mix is the port's copy of upstream's gendat
    (``gendat.generate_arrays``): every row is gene g < count / 2 holding
    planted read g % 10 exactly at offset g % 10, and nothing else
    matches."""
    from muscato_tpu_torch.bench import gendat

    n, count, length = 5000, 300, 1000
    rs, ts = gendat.generate_arrays(n, 100, count, length, seed=3)
    with open(os.path.join(HERE, "traffic", "gendat.json")) as f:
        mix = {**json.load(f), "reads_per_call": n, "shift_span": 100}
    genes, gs, codes = traffic.make_cell_data({"count": count, "length": length}, 100, mix, 3,
                                              "cpu")
    for rows, reads in ((_planted_rows(genes, gs, codes), codes),
                        (_planted_rows(torch.from_numpy(np.asarray(ts.tcat)),
                                       np.asarray(ts.gene_start), rs.codes), rs.codes)):
        assert len(rows) == count // 2
        np.testing.assert_array_equal(np.sort(rows[:, 1]), np.arange(count // 2))
        assert (rows[:, 2] == rows[:, 1] % 10).all() and (rows[:, 3] == 0).all()
        planted = {g % 10: r for r, g in rows[:, :2]}
        assert len(set(planted.values())) == 10
        assert all(planted[g % 10] == r for r, g in rows[:, :2])
    per_call = mix["reads_per_call"]
    assert set(planted.values()) <= set(range(len(codes) - per_call, per_call))  # in every call
