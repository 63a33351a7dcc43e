"""The logic of the card's runs past the flagship's gene set, held against
the JAX package at a small size: gene-range sharding with reads planted in
both shards (best+MMTol choosing across shards; a ``first``-mode
MaxMatches cap whose k-mer groups span both shards, so that it binds only
over the union), the gene-subset oracle (``bench/gene_subset.py``) against
the whole run of both packages, and the shard loop's build (on the device
only for a CUDA device).  Tolerance: exact.
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

from muscato_tpu import config as jconfig
from muscato_tpu.engine import pipeline as jpipeline
from muscato_tpu.io import reads as jreads
from muscato_tpu.io import targets as jtargets
from muscato_tpu_torch import config as tconfig
from muscato_tpu_torch.bench import gene_subset
from muscato_tpu_torch.engine import index as tindex
from muscato_tpu_torch.engine import pipeline as tpipeline
from muscato_tpu_torch.io.targets import TargetSet
from muscato_tpu_torch.ops.verify import mismatch_budget_table

NGENE, NREAD, NPLANT, READ_LEN = 240, 4000, 40, 100
SHARDS = 2
MODES = {"best": dict(MatchMode="best", MaxMatches=10**6),
         "first-capped": dict(MatchMode="first", MaxMatches=2)}


def _cfg(mode, batch=0):
    return tconfig.Config(
        Windows=[10, 30, 50, 70], WindowWidth=20, PMatch=0.96, MinDinuc=3,
        MaxReadLength=200, MMTol=2, ReadBatch=batch, **MODES[mode])


def _jax(cfg, rs, ts):
    """The same Config, ReadSet and TargetSet as the JAX package's types."""
    jrs = jreads.ReadSet(codes=rs.codes, lengths=rs.lengths, counts=rs.counts,
                         names=rs.names, num_total=rs.num_total)
    jts = jtargets.TargetSet(tcat=ts.tcat, gene_start=ts.gene_start, names=ts.names,
                             lengths=ts.lengths)
    return jconfig.Config(**dataclasses.asdict(cfg)), jrs, jts


def _bounds(ts):
    """The shard loop's gene bounds for SHARDS shards."""
    b = np.searchsorted(np.asarray(ts.gene_start),
                        np.linspace(0, int(ts.gene_start[-1]), SHARDS + 1)).astype(np.int64)
    b[0], b[-1] = 0, ts.num_genes
    return b


@pytest.fixture(scope="module")
def case():
    """Random genes of 1,000-2,999 bases; reads planted in NPLANT of them
    and in groups of genes: pairs with one gene in each shard, and groups
    of four with two in each (their near copies fill a cap group from both
    shards)."""
    rng = np.random.default_rng(5)
    lengths = rng.integers(1_000, 3_000, NGENE)
    gs = np.concatenate([[0], np.cumsum(lengths)])
    ts = TargetSet(tcat=rng.integers(0, 4, int(gs[-1]), dtype=np.uint8), gene_start=gs,
                   names=[b"g%d" % i for i in range(NGENE)], lengths=lengths)
    b = _bounds(ts)
    pool = [rng.permutation(np.arange(b[i], b[i + 1])) for i in range(SHARDS)]
    groups = [(pool[0][i], pool[1][i]) for i in range(8)]
    groups += [(pool[0][8 + 2 * i], pool[1][8 + 2 * i], pool[0][9 + 2 * i],
                pool[1][9 + 2 * i]) for i in range(8)]
    genes = rng.choice(NGENE, NPLANT, replace=False)
    rs, plants = gene_subset.plant_reads(ts, genes, NREAD, groups, seed=6)
    return rs, ts, plants


@pytest.fixture(scope="module")
def jax_whole(case):
    """The JAX engine's whole (unsharded) run of each mode."""
    rs, ts = case[:2]
    return {mode: jpipeline.run_matching(*_jax(_cfg(mode), rs, ts)) for mode in MODES}


def _assert_same(got, exp):
    assert len(exp.read_row) > 0
    for f in ("read_row", "gene", "start", "nmiss"):
        np.testing.assert_array_equal(getattr(got, f), getattr(exp, f), err_msg=f)


def _budget(cfg):
    """The mismatch budget of the planted reads' length."""
    return int(mismatch_budget_table(cfg.PMatch, cfg.MaxReadLength)[READ_LEN])


def _rows(mr):
    return set(zip(mr.read_row.tolist(), mr.gene.tolist(), mr.start.tolist(),
                   mr.nmiss.tolist()))


def _alone(cfg, rs, ts, lo, hi):
    """Rows of genes [lo, hi) of ``ts`` run alone, with global gene ids."""
    mr = tpipeline.run_matching(cfg, rs, tpipeline.gene_range(ts, lo, hi), device="cpu")
    return {(r, g + lo, s, x) for r, g, s, x in _rows(mr)}


@pytest.mark.parametrize("mode", list(MODES))
def test_gene_sharded_planted_in_both_shards_matches_jax(case, jax_whole, mode):
    """Two gene-range shards: the port equals the JAX package's sharded
    run, in one batch and in three (and in best mode both equal the whole
    run).  The plants reach
    across the shards: reads match in both shards, and the union drops a
    row that shard 1 run alone keeps (best mode: a better match of the
    read in shard 0, beyond MMTol; first mode: the MaxMatches cap of a
    k-mer group with rows in both shards, the row within MMTol of the
    read's best)."""
    rs, ts, plants = case
    cfg = _cfg(mode)
    for batch in (1536, 0):
        exp = jpipeline.run_matching_gene_sharded(*_jax(_cfg(mode, batch), rs, ts), SHARDS)
        _assert_same(tpipeline.run_matching_gene_sharded(
            _cfg(mode, batch), rs, ts, SHARDS, device="cpu"), exp)
        if mode == "best":
            _assert_same(exp, jax_whole[mode])
        else:
            # Not the whole run's rows, in either package: each shard's
            # (and each batch's) rank dedups (read, gene, start) and
            # applies best+MMTol before the union's cap, so a row keeps
            # the cap group of one of its windows only, and rows that
            # fall to best+MMTol hold no cap slot.
            assert _rows(jax_whole[mode]) != _rows(exp)

    b = _bounds(ts)
    got = _rows(exp)
    shard_of = {r: set() for r in exp.read_row.tolist()}
    for r, g, _, _ in got:
        shard_of[r].add(int(g >= b[1]))
    assert any(len(s) == 2 for s in shard_of.values()), "no read matched in both shards"
    dropped = _alone(cfg, rs, ts, int(b[1]), int(b[2])) - got
    best = {}
    for r, _, _, x in got:
        best[r] = min(best.get(r, x), x)
    by_cap = [row for row in dropped if row[0] in best and row[3] <= best[row[0]] + cfg.MMTol]
    if mode == "best":
        assert dropped and not by_cap
        expect = plants.best_genes(_budget(cfg), cfg.MMTol)
        assert len(expect) == len(plants.groups)
        for row, genes in expect.items():
            assert {g for r, g, _, _ in got if r == row} == genes
        assert any(len({int(g >= b[1]) for g in genes}) == 2 for genes in expect.values())
    else:
        assert by_cap, "the cap did not bind across the shards"


@pytest.mark.parametrize("mode", list(MODES))
def test_oracle_equals_whole_run(case, jax_whole, mode):
    """The gene-subset oracle over the planted genes equals the port's and
    the JAX package's whole runs; given named genes beyond the planted
    ones, it still does; and the match set is not empty in the planted
    genes of both shards."""
    rs, ts, plants = case
    planted = plants.genes
    cfg = _cfg(mode)
    whole = tpipeline.run_matching(cfg, rs, ts, device="cpu")
    _assert_same(whole, jax_whole[mode])
    assert set(whole.gene.tolist()) <= set(planted.tolist())
    _assert_same(gene_subset.oracle(cfg, rs, ts, whole.gene, planted), whole)
    extra = np.setdiff1d(np.arange(ts.num_genes), planted)[:5]
    _assert_same(gene_subset.oracle(cfg, rs, ts, extra, planted), whole)
    assert set((whole.gene >= _bounds(ts)[1]).tolist()) == {False, True}


def test_plant_reads_counts_and_copies(case):
    """Three quarters of the reads are planted; each group's genes hold a
    copy of its read with the group's distinct substitution counts, none
    in the first window; the subset TargetSet holds the planted genes."""
    rs, ts, plants = case
    assert rs.num_total == NREAD and int(rs.counts.sum()) == NREAD
    gs = np.asarray(ts.gene_start)
    for genes, subs, row in plants.groups:
        assert len(set(subs.tolist())) == len(subs) and set(genes) <= set(plants.genes)
        x = rs.codes[row]
        for g, c in zip(genes, subs):
            seg = np.lib.stride_tricks.sliding_window_view(ts.tcat[gs[g]:gs[g + 1]], READ_LEN)
            miss = (seg != x).sum(axis=1)
            at = int(np.argmin(miss))
            assert miss[at] == c and (seg[at, 10:30] == x[10:30]).all()
    sub = gene_subset.subset_targets(ts, plants.genes)
    assert sub.num_genes == len(plants.genes)
    sgs = np.asarray(sub.gene_start)
    for i, g in enumerate(plants.genes):
        np.testing.assert_array_equal(sub.tcat[sgs[i]:sgs[i + 1]], ts.tcat[gs[g]:gs[g + 1]])


@pytest.mark.parametrize("device,device_build", [("cpu", False), ("cuda", True)])
def test_shard_loop_builds_on_the_device_only_for_cuda(case, monkeypatch, device,
                                                       device_build):
    """The shard loop asks for the device build (with the second key word)
    on a CUDA device and the host build elsewhere, and logs each shard's
    build and match seconds and probe kind; the recorder builds on the CPU
    whatever the device, so no card is needed."""
    rs, ts = case[:2]
    seen = []
    real = tindex.build_target_index

    def record(sub, width, dev, device_build=False, keep_k2=True):
        seen.append((str(torch.device(dev)), device_build, keep_k2))
        return real(sub, width, "cpu", device_build=device_build, keep_k2=keep_k2)

    monkeypatch.setattr(tpipeline, "build_target_index", record)
    # A handler of its own on the logger: the drivers' log setup turns its
    # parent's propagation off.
    messages = []
    handler = logging.Handler(logging.INFO)
    handler.emit = lambda rec: messages.append(rec.getMessage())
    lg = logging.getLogger("muscato.pipeline")
    level = lg.level
    lg.setLevel(logging.INFO)
    lg.addHandler(handler)
    timings = {}
    try:
        tpipeline.run_matching_gene_sharded(_cfg("best"), rs, ts, SHARDS,
                                            device=torch.device(device), timings=timings)
    finally:
        lg.removeHandler(handler)
        lg.setLevel(level)
    assert seen == [(device, device_build, True)] * SHARDS
    lines = [m for m in messages if m.startswith("gene shard")]
    kind = "device" if device_build else "host"
    assert len(lines) == SHARDS and all(f"; {kind} build " in m and ", probe sorted_join" in m
                                        for m in lines)
    assert [s["probe_kind"] for s in timings["shards"]] == ["sorted_join"] * SHARDS
