"""The port's search probe (muscato_tpu_torch.ops.search, SearchAux, the
direct and binary probes, probe auto-selection) against muscato_tpu on the
same inputs, on the CPU; every comparison is exact.

- SearchAux: mode, bucket bits, upshift and every table bit for bit, for
  hash-uniform width-16 keys (direct), skewed width-13 keys (binary) and
  an index loaded from a file the JAX package wrote.
- searchsorted2_bucketed and searchsorted2, with and without the second
  key and the interleaved table, on keys >= 2**31 and duplicate runs.
- Each probe stage against the JAX stage: the JAX sort leaves equal keys in
  no defined order, so the active (lo, count, qid) slots compare as a
  multiset, with lo nondecreasing and equal totals; keyf/key2f exactly.
- Whole runs through probe="search" in both modes, and probe=None with a
  ReadBatch small enough that both packages pick the search probe.
- The one-call match_windows and match_windows_dedup against the JAX
  functions, with and without the search probe and with a survivor cut.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muscato_tpu import config as jconfig
from muscato_tpu.bench import gendat as jgendat
from muscato_tpu.engine import index as jindex
from muscato_tpu.engine import pipeline as jpipeline
from muscato_tpu.io import seqcodec as jseqcodec
from muscato_tpu.io.reads import ReadSet as JReadSet
from muscato_tpu.io.targets import TargetSet as JTargetSet
from muscato_tpu.ops import fused as jfused
from muscato_tpu.ops import packed as jpacked
from muscato_tpu.ops import search as jsearch
from muscato_tpu_torch import config as tconfig
from muscato_tpu_torch.bench import gendat as tgendat
from muscato_tpu_torch.engine import index as tindex
from muscato_tpu_torch.engine import pipeline as tpipeline
from muscato_tpu_torch.io import seqcodec as tseqcodec
from muscato_tpu_torch.io.reads import ReadSet as TReadSet
from muscato_tpu_torch.io.targets import TargetSet as TTargetSet
from muscato_tpu_torch.ops import fused as tfused
from muscato_tpu_torch.ops import packed as tpacked
from muscato_tpu_torch.ops import search as tsearch

_ARGS = (1500, 100, 100, 1000)
WINDOWS = (10, 30, 50, 70)


@pytest.fixture(scope="module")
def workload():
    return tgendat.generate_arrays_realistic(*_ARGS, seed=3)


@pytest.fixture(scope="module")
def jax_workload():
    return jgendat.generate_arrays_realistic(*_ARGS, seed=3)


def _skewed_sets(mods):
    """The skewed width-13 workload of tests/test_kernels.py
    (test_binary_probe_fallback_on_skewed_keys): every gene is 'A'*10 + 3
    random bases twice, so every distinct key lands in one bucket.
    ``mods`` is (seqcodec, ReadSet, TargetSet) of one package."""
    seqcodec, ReadSet, TargetSet = mods
    rng = np.random.default_rng(21)
    genes = []
    for _ in range(40):
        tail = "".join("ACGT"[i] for i in rng.integers(0, 4, 3))
        genes.append("A" * 10 + tail + "A" * 10 + tail)
    reads = [g[:20] for g in genes[:25]]
    codes, lengths = seqcodec.encode_rows([r.encode() for r in reads], 32)
    rs = ReadSet(codes=codes, lengths=lengths,
                 counts=np.ones(len(reads), dtype=np.int64), num_total=len(reads))
    gene_start = np.concatenate([[0], np.cumsum([len(g) for g in genes])]).astype(np.int64)
    ts = TargetSet(
        tcat=np.concatenate([seqcodec.encode(g.encode()) for g in genes]).astype(np.uint8),
        gene_start=gene_start, names=[b"g%d" % i for i in range(len(genes))],
        lengths=np.diff(gene_start),
    )
    return rs, ts


_JAX_MODS = (jseqcodec, JReadSet, JTargetSet)
_PORT_MODS = (tseqcodec, TReadSet, TTargetSet)


def _bits(x) -> np.ndarray:
    """A device array of either package as int32 bit patterns."""
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.int32)


def _assert_same_aux(t, j):
    assert (t.mode, t.bucket_bits, t.upshift, t.probe_steps) == (
        j.mode, j.bucket_bits, j.upshift, j.probe_steps)
    names = ("sbucket", "urec") if j.mode == "direct" else (
        "sbucket", "ukeys", "ukeys2", "ustart", "ucount", "ukk")
    for name in names:
        np.testing.assert_array_equal(_bits(getattr(t, name)), _bits(getattr(j, name)),
                                      err_msg=name)


def _aux_case(case, workload, jax_workload, tmp_path):
    """(port index, JAX index) for one SearchAux case."""
    if case == "uniform-w16":
        return (tindex.build_target_index(workload[1], 16, "cpu"),
                jindex.build_target_index(jax_workload[1], 16))
    if case == "skewed-w13":
        return (tindex.build_target_index(_skewed_sets(_PORT_MODS)[1], 13, "cpu"),
                jindex.build_target_index(_skewed_sets(_JAX_MODS)[1], 13))
    path = str(tmp_path / "index.npz")
    jidx = jindex.build_target_index(jax_workload[1], 20)
    jidx.save(path)
    return tindex.TargetIndex.load(path, workload[1], 20, "cpu"), jidx


@pytest.mark.parametrize("case,mode", [("uniform-w16", "direct"), ("skewed-w13", "binary"),
                                       ("jax-index-file", "direct")])
def test_search_aux_matches_jax(workload, jax_workload, tmp_path, case, mode):
    tidx, jidx = _aux_case(case, workload, jax_workload, tmp_path)
    t, j = tidx.search_aux(), jidx.search_aux()
    assert j.mode == mode
    _assert_same_aux(t, j)
    assert tidx.search_aux() is t  # built once
    assert t.nbytes > 0 and t.build_s >= 0


def test_binary_aux_when_direct_bits_are_capped(workload, jax_workload, monkeypatch):
    """Below the direct table's bits both packages take the binary layout."""
    monkeypatch.setattr(tindex, "MAX_DIRECT_BITS", 15)
    monkeypatch.setattr(jindex, "MAX_DIRECT_BITS", 15)
    t = tindex.build_target_index(workload[1], 20, "cpu").search_aux()
    j = jindex.build_target_index(jax_workload[1], 20).search_aux()
    assert t.mode == "binary"
    _assert_same_aux(t, j)


def _sorted_table(rng, n, use_k2):
    """Sorted (a1, a2) uint32 entries with duplicate runs and keys >= 2**31."""
    a1 = rng.integers(0, 2**32, n // 2, dtype=np.uint64).astype(np.uint32)
    a1 = np.concatenate([a1, np.repeat(a1[:20], 7), [0, 2**31, 2**32 - 1] * 3]).astype(np.uint32)
    a2 = (rng.integers(0, 2**32, a1.size, dtype=np.uint64).astype(np.uint32) if use_k2
          else np.zeros(a1.size, np.uint32))
    a2[:40] = 0xFFFFFFFF
    order = np.lexsort((a2, a1))
    return a1[order], a2[order]


def _queries(rng, a1, a2, m):
    pick = rng.integers(0, a1.size, m)
    k1 = np.concatenate([a1[pick], rng.integers(0, 2**32, m, dtype=np.uint64).astype(np.uint32),
                         [0, 2**31 - 1, 2**31, 2**32 - 1]]).astype(np.uint32)
    k2 = np.concatenate([a2[pick], rng.integers(0, 2**32, m + 4, dtype=np.uint64).astype(np.uint32)])
    return k1, k2.astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("width", [12, 20], ids=["no-k2", "k2"])
@pytest.mark.parametrize("interleaved", [False, True], ids=["split", "interleaved"])
def test_searchsorted2_bucketed_matches_jax(width, interleaved):
    rng = np.random.default_rng(width)
    use_k2 = width > 13
    a1, a2 = _sorted_table(rng, 5000, use_k2)
    k1, k2 = _queries(rng, a1, a2, 3000)
    upshift = jsearch.bucket_shift(width)
    assert tsearch.bucket_shift(width) == upshift
    bucket, steps, bits = jsearch.build_buckets_host(a1, upshift, 12)
    tb, ts_, tbits = tsearch.build_buckets_host(a1, upshift, 12)
    np.testing.assert_array_equal(tb, bucket)
    assert (ts_, tbits) == (steps, bits)
    inter = np.stack([a1, a2], axis=1).reshape(-1)
    exp = jsearch.searchsorted2_bucketed(
        jnp.asarray(a1), jnp.asarray(a2), jnp.asarray(k1), jnp.asarray(k2),
        jnp.asarray(bucket), upshift=upshift, steps=steps, use_k2=use_k2,
        bucket_bits=bits, interleaved=jnp.asarray(inter) if interleaved else None)
    got = tsearch.searchsorted2_bucketed(
        _t(a1), _t(a2), _t(k1), _t(k2), torch.from_numpy(bucket), upshift=upshift,
        steps=steps, use_k2=use_k2, bucket_bits=bits,
        interleaved=_t(inter) if interleaved else None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    np.testing.assert_array_equal(
        tsearch.bucket_of(_t(k1), upshift).numpy(), np.asarray(jsearch.bucket_of(jnp.asarray(k1), upshift)))


@pytest.mark.parametrize("side", ["left", "right"])
def test_searchsorted2_matches_jax(side):
    rng = np.random.default_rng(7)
    a1, a2 = _sorted_table(rng, 4000, True)
    k1, k2 = _queries(rng, a1, a2, 2000)
    exp = jsearch.searchsorted2(jnp.asarray(a1), jnp.asarray(a2), jnp.asarray(k1),
                                jnp.asarray(k2), side=side)
    got = tsearch.searchsorted2(_t(a1), _t(a2), _t(k1), _t(k2), side=side)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))


def _stage_inputs(case, workload, jax_workload):
    """(port index, JAX index, port (rpacked, lengths), JAX (rpacked,
    lengths), windows, width, min_dinuc) for a probe stage case."""
    if case == "skewed-w13":
        trs, tts = _skewed_sets(_PORT_MODS)
        jrs, jts = _skewed_sets(_JAX_MODS)
        width, windows, min_dinuc = 13, (0,), 0
    else:
        (trs, tts), (jrs, jts) = workload, jax_workload
        width, windows, min_dinuc = 20, WINDOWS, 3
    tidx = tindex.build_target_index(tts, width, "cpu")
    jidx = jindex.build_target_index(jts, width)
    n = min(trs.codes.shape[0], 2048)
    tin = (tpacked.pack_rows(torch.from_numpy(np.array(trs.codes[:n]))),
           torch.from_numpy(np.asarray(trs.lengths[:n], np.int32)))
    jin = (jpacked.pack_rows(jnp.asarray(jrs.codes[:n])), jnp.asarray(jrs.lengths[:n]))
    return tidx, jidx, tin, jin, windows, width, min_dinuc


def _active(counts, lo, qid):
    counts, lo, qid = (np.asarray(x).astype(np.int64) for x in (counts, lo, qid))
    act = counts > 0
    nact = int(act.sum())
    assert act[:nact].all() and not act[nact:].any(), "active slots not first"
    assert (np.diff(lo[:nact]) >= 0).all(), "active slots not in lo order"
    return sorted(zip(lo[:nact], counts[:nact], qid[:nact]))


@pytest.mark.parametrize("case,mode", [("realistic-w20", "direct"), ("skewed-w13", "binary"),
                                       ("realistic-w20-binary", "binary")])
def test_probe_stage_matches_jax(workload, jax_workload, monkeypatch, case, mode):
    if case.endswith("-binary"):
        monkeypatch.setattr(tindex, "MAX_DIRECT_BITS", 15)
        monkeypatch.setattr(jindex, "MAX_DIRECT_BITS", 15)
    tidx, jidx, tin, jin, windows, width, min_dinuc = _stage_inputs(
        case, workload, jax_workload)
    taux, jaux = tidx.search_aux(), jidx.search_aux()
    assert taux.mode == jaux.mode == mode
    exp = jfused.probe_windows(*jin, jnp.asarray(np.asarray(windows, np.int32)), jidx.skeys,
                               width=width, min_dinuc=min_dinuc, index_aux=jaux)
    got = tfused.probe_windows(*tin, windows, tidx.skeys, width=width,
                               min_dinuc=min_dinuc, index_aux=taux)
    assert int(got.total) == int(exp[5]) > 0
    assert _active(got.counts, got.lo, got.qid) == _active(exp[0], exp[1], exp[2])
    np.testing.assert_array_equal(got.keyf.numpy(), _bits(exp[3]))
    np.testing.assert_array_equal(got.key2f.numpy(), _bits(exp[4]))
    # The sorted join finds the same active slots.
    ref = tfused.probe_windows(*tin, windows, tidx.skeys, width=width, min_dinuc=min_dinuc)
    if width <= 13:
        assert _active(ref.counts, ref.lo, ref.qid) == _active(got.counts, got.lo, got.qid)


def _cfg(batch=0, config=tconfig, windows=WINDOWS):
    return config.Config(
        Windows=list(windows), WindowWidth=20, PMatch=0.96, MinDinuc=3,
        MaxReadLength=200, MMTol=2, MaxMatches=10**6, MatchMode="best",
        ReadBatch=batch,
    )


def _assert_same(got, exp):
    assert len(exp.read_row) > 0
    for f in ("read_row", "gene", "start", "nmiss"):
        np.testing.assert_array_equal(getattr(got, f), getattr(exp, f), err_msg=f)


def _jax_run(jax_workload, cfg, probe):
    jcfg = jconfig.Config(**dataclasses.asdict(cfg))
    jidx = jindex.build_target_index(jax_workload[1], cfg.WindowWidth)
    return jpipeline.run_matching_indexed(jcfg, jax_workload[0], jidx, probe=probe)


@pytest.mark.parametrize("mode", ["direct", "binary"])
def test_search_probe_run_matches_jax(workload, jax_workload, monkeypatch, mode):
    if mode == "binary":
        monkeypatch.setattr(tindex, "MAX_DIRECT_BITS", 15)
        monkeypatch.setattr(jindex, "MAX_DIRECT_BITS", 15)
    cfg = _cfg()
    exp = _jax_run(jax_workload, cfg, "search")
    index = tpipeline.build_target_index(workload[1], 20, "cpu")
    timings = {}
    got = tpipeline.run_matching_indexed(cfg, workload[0], index, probe="search",
                                         timings=timings)
    assert timings["probe_kind"] == mode
    _assert_same(got, exp)
    # ... and the sorted join's result.
    _assert_same(tpipeline.run_matching_indexed(cfg, workload[0], index, probe="sort"), got)


def test_auto_selects_search_probe_as_jax_does(workload, jax_workload):
    """V > 64 x (windows x batch): with 256-read batches both packages
    take the search probe; with the default batch, the sorted join."""
    rs, ts = workload
    index = tpipeline.build_target_index(ts, 20, "cpu")
    v = index.skeys.shape[0]
    assert v > 64 * len(WINDOWS) * 256 and v < 64 * len(WINDOWS) * rs.num_unique
    cfg = _cfg(batch=256)
    exp = jpipeline.run_matching(jconfig.Config(**dataclasses.asdict(cfg)), *jax_workload)
    timings = {}
    got = tpipeline.run_matching_indexed(cfg, rs, index, timings=timings)
    assert timings["probe_kind"] == "direct"
    assert timings["batches"] == -(-rs.num_unique // 256) > 2
    _assert_same(got, exp)
    default = {}
    tpipeline.run_matching_indexed(_cfg(), rs, index, timings=default)
    assert default["probe_kind"] == "sorted_join"


def test_probe_argument_is_checked(workload):
    index = tpipeline.build_target_index(workload[1], 20, "cpu")
    with pytest.raises(ValueError, match="probe"):
        tpipeline.run_matching_indexed(_cfg(), workload[0], index, probe="merge")


_ONE_CALL_CASES = {
    "dedup-search": (True, True, 1 << 14),
    "dedup-sort": (True, False, 1 << 14),
    "dedup-cut": (True, True, 100),
    "streaming-search": (False, True, 1 << 14),
    "streaming-sort": (False, False, 1 << 14),
    "streaming-cut": (False, True, 100),
}


def _one_call(pkg, dedup, aux, surv_cap, w):
    """One call of ``pkg``'s match_windows_dedup (dedup) or match_windows
    on the first 1024 reads; ``w`` holds each package's inputs."""
    d = w[pkg]
    idx = d["idx"]
    kw = dict(width=20, min_dinuc=3, max_read_length=200, surv_cap=surv_cap,
              smax=idx.num_bases, index_aux=idx.search_aux() if aux else None)
    if pkg == "jax":
        args = (*d["in"], d["q1s"], idx.skeys, idx.spos, idx.tpacked, idx.gene_start,
                d["budget"])
        gblock, gsteps = idx.gene_block()
        if dedup:
            out = jfused.match_windows_dedup(*args, pair_cap=1 << 18, vchunk=1 << 16,
                                             trows=idx.trows(d["in"][0].shape[1]),
                                             gblock=gblock, gsteps=gsteps, **kw)
        else:
            out = jfused.match_windows(*args, pair_chunk=4096, **kw)
        return np.asarray(out[0]), int(out[1]), int(out[2])
    args = (*d["in"], d["q1s"], idx.skeys, idx.spos, idx.gene_start, d["budget"])
    gblock, gsteps = idx.gene_block()
    kw.update(trows=idx.trows(d["in"][0].shape[1]), gblock=gblock, gsteps=gsteps)
    if dedup:
        out = tfused.match_windows_dedup(*args, pair_cap=1 << 18, vchunk=1 << 16, **kw)
    else:
        out = tfused.match_windows(*args, pair_chunk=4096, **kw)
    return out[0].numpy(), int(out[1]), int(out[2])


@pytest.fixture(scope="module")
def one_call_inputs(workload, jax_workload):
    from muscato_tpu.ops import verify as jverify
    from muscato_tpu_torch.ops import verify as tverify

    n = 1024
    (trs, tts), (jrs, jts) = workload, jax_workload
    return {
        "jax": dict(idx=jindex.build_target_index(jts, 20),
                    **{"in": (jpacked.pack_rows(jnp.asarray(jrs.codes[:n])),
                              jnp.asarray(jrs.lengths[:n]))},
                    q1s=jnp.asarray(np.asarray(WINDOWS, np.int32)),
                    budget=jnp.asarray(jverify.mismatch_budget_table(0.96, 200))),
        "port": dict(idx=tindex.build_target_index(tts, 20, "cpu"),
                     **{"in": (tpacked.pack_rows(torch.from_numpy(np.array(trs.codes[:n]))),
                               torch.from_numpy(np.asarray(trs.lengths[:n], np.int32)))},
                     q1s=WINDOWS,
                     budget=torch.from_numpy(tverify.mismatch_budget_table(0.96, 200))),
    }


@pytest.mark.parametrize("case", list(_ONE_CALL_CASES))
def test_one_call_match_matches_jax(one_call_inputs, case):
    """match_windows_dedup and match_windows against the JAX functions on
    the same reads and index, with the search probe (index_aux) and
    without: survivor count and pair total exactly, the survivor rows as a
    multiset (the packages order equal probe keys differently).  With
    surv_cap below the survivor count ("cut") both keep surv_cap rows, all
    of them survivors; the dedup path keeps the lowest (window, read)
    queries, so its rows below the last kept query are the JAX rows."""
    dedup, aux, surv_cap = _ONE_CALL_CASES[case]
    surv_j, nsurv_j, total_j = _one_call("jax", dedup, aux, surv_cap, one_call_inputs)
    surv_t, nsurv_t, total_t = _one_call("port", dedup, aux, surv_cap, one_call_inputs)
    assert (nsurv_t, total_t) == (nsurv_j, total_j) and total_j > 0
    assert surv_t.shape == surv_j.shape == (surv_cap, tfused.NCOL)
    k = min(nsurv_j, surv_cap)
    rows_t = sorted(map(tuple, surv_t[:k].tolist()))
    rows_j = sorted(map(tuple, np.asarray(surv_j)[:k].tolist()))
    if nsurv_j <= surv_cap:
        assert nsurv_j > 100
        assert rows_t == rows_j
        return
    assert case.endswith("-cut")
    full, _, _ = _one_call("jax", dedup, aux, 1 << 14, one_call_inputs)
    every = sorted(map(tuple, full[:nsurv_j].tolist()))
    assert all(r in every for r in rows_t) and len(rows_t) == surv_cap
    if dedup:
        nreads = one_call_inputs["port"]["in"][0].shape[0]
        qid = lambda r: r[6] * nreads + r[0]  # noqa: E731  (window, read) query id
        last = max(qid(r) for r in rows_j)
        assert max(qid(r) for r in rows_t) == last
        assert [r for r in rows_t if qid(r) < last] == [r for r in rows_j if qid(r) < last]
