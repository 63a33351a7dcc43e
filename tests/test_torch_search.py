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
- The search aux built by torch ops (build_search_aux_device) against the
  JAX numpy build and the port's; the probe bodies' twins
  (direct_probe_torch, binary_probe_torch) against the JAX bodies query by
  query; a model of each CUDA kernel's loop (tests/probe_cases.py)
  against the twins on the kernels' branch cases, and chip_smoke's bytes
  and sectors of each kernel against what its model reads; report bytes
  of whole search-probe runs.
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
from muscato_tpu.engine import report as jreport
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
from muscato_tpu_torch.engine import report as treport
from muscato_tpu_torch.io import seqcodec as tseqcodec
from muscato_tpu_torch.io.reads import ReadSet as TReadSet
from muscato_tpu_torch.io.targets import TargetSet as TTargetSet
from muscato_tpu_torch.ops import fused as tfused
from muscato_tpu_torch.ops import packed as tpacked
from muscato_tpu_torch.ops import search as tsearch
import probe_cases

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


# The search aux built by torch ops (build_search_aux_device, on the CPU
# device here) against the JAX package's numpy build and the port's own.

def _aux_table(case, rng):
    """(sorted k1, sorted k2, width) of one aux-build case."""
    u32 = lambda n, hi=2**32: rng.integers(0, hi, n, dtype=np.uint64).astype(np.uint32)  # noqa: E731
    if case == "empty":
        return np.zeros(0, np.uint32), np.zeros(0, np.uint32), 20
    if case == "one key":
        return np.full(50, 77, np.uint32), np.full(50, 3, np.uint32), 20
    if case == "few keys":
        k1 = np.repeat(u32(10), 4)
        k2 = np.zeros_like(k1) + 9
        width = 20
    elif case.startswith("w12"):
        hi = 2**32 if case.endswith("past range") else 5**12
        k1 = np.concatenate([u32(20_000, hi), np.repeat(u32(100, hi), 5)])
        k2 = np.zeros_like(k1)
        width = 12
    elif case == "w6 past range capped":  # 17 bucket bits + upshift 16 > 32
        k1 = np.concatenate([u32(2**20 + 5000), np.repeat(u32(100), 3)])
        k2 = np.zeros_like(k1)
        width = 6
    elif case == "w13 skewed":
        base = 5 << 15
        k1 = np.concatenate([base + np.arange(2000), np.arange(300) << 16, [0]]).astype(np.uint32)
        k2 = np.zeros_like(k1)
        width = 13
    else:  # w20 uniform / capped: two key words, runs, equal key1 under other key2
        k1 = np.concatenate([u32(30_000), np.repeat(u32(200), 3), [0, 2**32 - 1] * 2])
        k2 = u32(k1.size)
        k2[30_000:30_060] = 1
        width = 20
    order = np.lexsort((k2, k1))
    return k1[order].astype(np.uint32), k2[order].astype(np.uint32), width


_AUX_CASES = {"w20 uniform": "direct", "w12 exact": "direct", "w20 capped": "binary",
              "w13 skewed": "binary", "few keys": "direct", "w12 past range": "direct",
              "empty": "direct", "one key": "direct", "w12 past range capped": "binary",
              "w6 past range capped": "binary"}


@pytest.mark.parametrize("case", list(_AUX_CASES))
def test_device_aux_build_matches_jax(monkeypatch, case):
    """build_search_aux_device (torch ops) equals the JAX build_search_aux
    and the port's numpy build_search_aux array for array: both modes,
    key words with and without key2, MAX_DIRECT_BITS capped (w20 capped),
    fewer than 16 unique keys, keys past the width's range (their top-32
    image out of order; in binary mode at 16 and 17 bucket bits), no keys
    at all."""
    if case.endswith("capped"):
        monkeypatch.setattr(tindex, "MAX_DIRECT_BITS", 15)
        monkeypatch.setattr(jindex, "MAX_DIRECT_BITS", 15)
    k1, k2, width = _aux_table(case, np.random.default_rng(len(case)))
    new_run = np.concatenate([[True], (k1[1:] != k1[:-1]) | (k2[1:] != k2[:-1])])[:k1.size]
    starts = np.flatnonzero(new_run).astype(np.int32)
    counts = np.diff(np.append(starts, len(k1))).astype(np.int32)
    exp = jindex.build_search_aux(k1[starts], k2[starts], starts, counts, width)
    got = tindex.build_search_aux_device(_t(k1), _t(k2), width)
    assert got.mode == _AUX_CASES[case]
    _assert_same_aux(got, exp)
    _assert_same_aux(got, tindex.build_search_aux(k1[starts], k2[starts], starts, counts,
                                                  width, "cpu"))


def _per_query(n, qid, counts, loc):
    """(counts, loc) of each query id from a probe's slots."""
    c, lo = np.zeros(n, np.int64), np.zeros(n, np.int64)
    qid = np.asarray(qid).astype(np.int64)
    c[qid], lo[qid] = np.asarray(counts), np.asarray(loc)
    return c, lo


@pytest.mark.parametrize("width,mode", [(20, "direct"), (12, "direct"), (20, "binary"),
                                        (13, "binary")])
def test_probe_twins_match_jax_bodies(workload, jax_workload, monkeypatch, width, mode):
    """direct_probe_torch and binary_probe_torch on the port's sorted
    queries give each query the JAX probe body's (count, loc), read off
    the JAX stage's slots by query id (both ends of the compaction are
    permutations of every query): exact, hits under an invalid query's
    start included."""
    if width == 13:
        (trs, tts), (jrs, jts) = _skewed_sets(_PORT_MODS), _skewed_sets(_JAX_MODS)
        windows, min_dinuc = (0,), 0
    else:
        (trs, tts), (jrs, jts) = workload, jax_workload
        windows, min_dinuc = WINDOWS, 3
    if mode == "binary" and width == 20:
        monkeypatch.setattr(tindex, "MAX_DIRECT_BITS", 15)
        monkeypatch.setattr(jindex, "MAX_DIRECT_BITS", 15)
    tidx = tindex.build_target_index(tts, width, "cpu")
    jidx = jindex.build_target_index(jts, width)
    taux, jaux = tidx.search_aux(), jidx.search_aux()
    assert taux.mode == jaux.mode == mode
    n = min(trs.codes.shape[0], 2048)
    tin = (tpacked.pack_rows(torch.from_numpy(np.array(trs.codes[:n]))),
           torch.from_numpy(np.asarray(trs.lengths[:n], np.int32)))
    jin = (jpacked.pack_rows(jnp.asarray(jrs.codes[:n])), jnp.asarray(jrs.lengths[:n]))
    exp = jfused.probe_windows(*jin, jnp.asarray(np.asarray(windows, np.int32)), jidx.skeys,
                               width=width, min_dinuc=min_dinuc, index_aux=jaux)
    _, (keyf, key2f, validf, qid) = tfused._sorted_queries(
        *tin, windows, width=width, min_dinuc=min_dinuc)
    use_k2 = width > 13
    if mode == "direct":
        counts, loc = tsearch.direct_probe_torch(
            keyf, key2f, validf, taux.urec, taux.sbucket, upshift=taux.upshift,
            bucket_bits=taux.bucket_bits, bucket_width=tindex.DIRECT_BUCKET_WIDTH,
            use_k2=use_k2)
    else:
        counts, loc = tsearch.binary_probe_torch(
            keyf, key2f, validf, taux.ukeys, taux.ukeys2, taux.ukk, taux.ustart, taux.ucount,
            taux.sbucket, upshift=taux.upshift, bucket_bits=taux.bucket_bits,
            probe_steps=taux.probe_steps, use_k2=use_k2)
    nq = keyf.shape[0]
    got = _per_query(nq, qid.numpy(), counts.numpy(), loc.numpy())
    want = _per_query(nq, exp[2], exp[0], exp[1])
    assert (got[0] > 0).sum() > 10
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("case", list(probe_cases.cases()))
def test_probe_kernel_model_matches_twin(case):
    """A per-query model of each kernel (csrc/probe.cu) equals the twin on
    every query of the branch cases that the card's tests and
    chip_smoke.py hold the kernels to: the one-thread kernels of the
    -DMUSCATO_NO_STAGE build (B8 scans min(bucket size, width) records, B9
    stops its search once lo == hi and reads the keys as ukk's pairs), and
    those of the default build (B8's 4 lanes each take every fourth record
    and sum by xor shuffles; B9's rounds of a window of 4 pairs around an
    interpolated guess down to the insertion point, the twin's rounds
    replayed on indices).  On the CPU the wrappers are the twins and
    launch nothing."""
    kind, aux, width, q = probe_cases.cases()[case]
    args, kw = probe_cases.probe_args(kind, aux, width, q)
    wrapper, twin, model, design_model = {
        "direct": (tsearch.direct_probe, tsearch.direct_probe_torch, probe_cases.direct_model,
                   probe_cases.direct_group_model),
        "binary": (tsearch.binary_probe, tsearch.binary_probe_torch, probe_cases.binary_model,
                   probe_cases.binary_window_model),
    }[kind]
    before = wrapper.launches
    got = wrapper(*args, **kw)
    assert wrapper.launches == before
    for a, b in zip(got, twin(*args, **kw)):
        assert a.dtype == torch.int32 and torch.equal(a, b)
    for label, fn in {"one thread": model, "default build": design_model}.items():
        counts, loc = fn(*args, **kw)
        assert (counts > 0).sum() > 10 and (~q[2]).any(), label
        np.testing.assert_array_equal(got[0].numpy(), counts, err_msg=label)
        np.testing.assert_array_equal(got[1].numpy().view(np.uint32), loc.astype(np.uint32),
                                      err_msg=label)


@pytest.mark.parametrize("steps", [0, 1, 3, 5])
def test_binary_window_model_with_fewer_steps_matches_twin(steps):
    """B9's window search is exact for every probe_steps the launcher takes,
    not only the aux's: with fewer rounds than its largest bucket needs,
    the twin's search stops short of the insertion point for some queries,
    and the kernel's replay of the twin's rounds on indices stops there
    too."""
    kind, aux, width, q = probe_cases.cases()["a binary bucket of 2**probe_steps - 1 keys"]
    args, kw = probe_cases.probe_args(kind, aux, width, q)
    full = tsearch.binary_probe_torch(*args, **kw)
    kw["probe_steps"] = steps
    exp = tsearch.binary_probe_torch(*args, **kw)
    assert not torch.equal(exp[0], full[0])
    counts, loc = probe_cases.binary_window_model(*args, **kw)
    np.testing.assert_array_equal(exp[0].numpy(), counts)
    np.testing.assert_array_equal(exp[1].numpy(), loc)


def test_binary_aux_columns_share_two_tensors():
    """The binary aux keeps 16 bytes a unique key beside its bucket table:
    ukeys and ukeys2 are ukk's columns, ustart and ucount the columns of
    one (U, 2) tensor, and nbytes counts each storage once."""
    _, aux, _, _ = probe_cases.cases()["w20 binary"]
    u = aux.ukeys.numel()
    assert aux.ukeys.data_ptr() == aux.ukk.data_ptr()
    assert aux.ukeys2.data_ptr() == aux.ukk.data_ptr() + 4
    assert aux.ucount.data_ptr() == aux.ustart.data_ptr() + 4
    assert aux.ustart.stride() == aux.ucount.stride() == (2,)
    assert aux.nbytes == 16 * u + 4 * aux.sbucket.numel()


def test_probe_wrappers_refuse_other_devices():
    """A tensor neither on the CPU nor on a CUDA device never reaches a
    twin: the wrappers raise."""
    kind, aux, width, q = probe_cases.cases()["w20 direct"]
    args, kw = probe_cases.probe_args(kind, aux, width, q)
    with pytest.raises(ValueError, match="direct_probe"):
        tsearch.direct_probe(args[0].to("meta"), *args[1:], **kw)
    kind, aux, width, q = probe_cases.cases()["w20 binary"]
    args, kw = probe_cases.probe_args(kind, aux, width, q)
    with pytest.raises(ValueError, match="binary_probe"):
        tsearch.binary_probe(*args[:-1], args[-1].to("meta"), **kw)


@pytest.mark.parametrize("mode", ["direct", "binary"])
def test_search_probe_report_bytes_match_jax(workload, jax_workload, monkeypatch, tmp_path,
                                             mode):
    """Whole runs through probe="search" in each mode: the four report
    files the port writes from its MatchResult equal the JAX package's
    from its own run."""
    if mode == "binary":
        monkeypatch.setattr(tindex, "MAX_DIRECT_BITS", 15)
        monkeypatch.setattr(jindex, "MAX_DIRECT_BITS", 15)
    cfg = _cfg()
    jmr = _jax_run(jax_workload, cfg, "search")
    index = tpipeline.build_target_index(workload[1], 20, "cpu")
    timings = {}
    mr = tpipeline.run_matching_indexed(cfg, workload[0], index, probe="search",
                                        timings=timings)
    assert timings["probe_kind"] == mode and len(mr.read_row) > 0
    files = {}
    for mod, name, m, (rs, ts) in ((treport, "t.txt", mr, workload),
                                   (jreport, "j.txt", jmr, jax_workload)):
        path = str(tmp_path / name)
        table = mod.write_results(path, m, rs, ts)
        mod.write_nonmatch(path, m, rs)
        mod.write_readstats(path, table)
        mod.write_genestats(path, table)
        files[name] = [open(p, "rb").read() for p in (
            path, mod.nonmatch_path(path), mod._stats_path(path, "readstats"),
            mod._stats_path(path, "genestats"))]
    assert files["t.txt"] == files["j.txt"]


def _chip_smoke():
    """chip_smoke.py at the repository root, imported by path."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("case", ["w20 direct", "w12 binary", "binary, full steps"])
def test_probe_bounds_count_what_the_kernels_read(case):
    """chip_smoke's bytes of B8 and B9 (call_work: each table entry read
    once) and their 32-byte sectors (probe_sector_bytes) equal a count,
    entry by entry, of what each kernel's per-query model reads, beside
    the query arrays and the two outputs whole."""
    kind, aux, width, q = probe_cases.cases()[case]
    args, kw = probe_cases.probe_args(kind, aux, width, q)
    entries = set()
    model = probe_cases.direct_model if kind == "direct" else probe_cases.binary_model
    model(*args, **kw, touch=lambda array, index, nbytes: entries.add((array, index, nbytes)))
    nq, k2 = q[0].numel(), int(kw["use_k2"])
    per_query = 4 + 4 * k2 + 1 + 8  # key1, key2, validity, counts and loc
    cs = _chip_smoke()
    name = f"{kind}_probe"
    assert cs.call_work(name, args, kw)[0] == nq * per_query + sum(e[2] for e in entries)
    sectors = {(array, (index * nbytes + byte) >> 5) for array, index, nbytes in entries
               for byte in range(nbytes)}
    whole = sum(-(-nbytes // 32) for nbytes in [4 * nq] * (3 + k2) + [nq])
    assert cs.probe_sector_bytes(name, args, kw) == 32 * (whole + len(sectors))
