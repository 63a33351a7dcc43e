"""The port's streaming expand-verify against the JAX package's, on the
same seeded inputs.

Every output is integer, so equality is exact: the per-pair verify and
the non-monotone gene lookup lane by lane, the streaming stage's survivor
buffer row by row (several chunks, and a survivor capacity that
overflows), and the MatchResult of whole runs that take the streaming
expand (NoDedup, 32 windows, a pair total above a lowered
``_MAX_PAIR_CAP``, a survivor capacity that forces a re-run).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from muscato_tpu import config as jconfig
from muscato_tpu.bench import gendat as jgendat
from muscato_tpu.engine import index as jindex
from muscato_tpu.engine import pipeline as jpipeline
from muscato_tpu.ops import fused as jfused
from muscato_tpu.ops import packed as jpacked
from muscato_tpu.ops import verify as jverify
from muscato_tpu_torch import config as tconfig
from muscato_tpu_torch.bench import gendat as tgendat
from muscato_tpu_torch.engine import index as tindex
from muscato_tpu_torch.engine import pipeline as tpipeline
from muscato_tpu_torch.ops import fused as tfused
from muscato_tpu_torch.ops import packed as tpacked

_ARGS = (5000, 100, 200, 1000)  # tests/test_torch_pipeline.py's workload


def _t(a) -> torch.Tensor:
    a = np.array(a)  # a writable copy (jax arrays are read-only)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


@pytest.fixture(scope="module")
def workload():
    return tgendat.generate_arrays_realistic(*_ARGS, seed=1)


@pytest.fixture(scope="module")
def jax_workload():
    return jgendat.generate_arrays_realistic(*_ARGS, seed=1)


def _cfg(windows=(10, 30, 50, 70), batch=0, config=tconfig, **kw):
    return config.Config(
        Windows=list(windows), WindowWidth=20, PMatch=0.96, MinDinuc=3,
        MaxReadLength=200, MMTol=2, MaxMatches=10**6, MatchMode="best",
        ReadBatch=batch, **kw,
    )


_JAX_RESULTS = {}


def _jax_result(jax_workload, cfg, max_pair_cap=None):
    """The JAX engine's MatchResult for the port's config, with its
    ``_MAX_PAIR_CAP`` lowered when ``max_pair_cap`` is given (once a
    config)."""
    key = (repr(dataclasses.asdict(cfg)), max_pair_cap)
    if key not in _JAX_RESULTS:
        jcfg = jconfig.Config(**dataclasses.asdict(cfg))
        with pytest.MonkeyPatch.context() as mp:
            if max_pair_cap is not None:
                mp.setattr(jpipeline, "_MAX_PAIR_CAP", max_pair_cap)
            _JAX_RESULTS[key] = jpipeline.run_matching(jcfg, *jax_workload)
    return _JAX_RESULTS[key]


def _assert_same(got, exp):
    assert len(exp.read_row) > 0
    for f in ("read_row", "gene", "start", "nmiss"):
        np.testing.assert_array_equal(getattr(got, f), getattr(exp, f), err_msg=f)


# ---- the per-pair verify and its gene lookup -------------------------------


def test_gene_of_pos_block_matches_jax():
    """Positions in any order, the first and last base of every gene."""
    rng = np.random.default_rng(11)
    gene_start = np.concatenate([[0], np.cumsum(rng.integers(1, 900, 400))]).astype(np.int32)
    smax = int(gene_start[-1])
    gb, steps = tpacked.build_gene_block(gene_start, smax)
    p = np.concatenate([rng.integers(0, smax, 5000), gene_start[:-1],
                        gene_start[1:] - 1]).astype(np.int32)
    rng.shuffle(p)
    exp = jpacked.gene_of_pos_block(jnp.asarray(gene_start), jnp.asarray(gb),
                                    jnp.asarray(p), steps)
    got = tpacked.gene_of_pos_block(_t(gene_start), _t(gb), _t(p), steps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    assert got.numpy().max() == len(gene_start) - 2  # the last gene is hit


@pytest.mark.parametrize("seed", [0, 1])
def test_verify_pairs_packed_matches_jax(seed):
    """Lanes in random order with a window offset each: inactive lanes,
    negative diagonals, position-0 hits of reads longer than 100 with
    q1 == 0, hits in the last gene and planted exact matches.  Every
    output of every lane must be equal."""
    rng = np.random.default_rng(40 + seed)
    max_rl, width, S = 160, 12, 7000
    gene_start = np.array([0, 1500, 2600, 4100, S], np.int32)
    tcat = rng.integers(0, 4, S).astype(np.uint8)
    nreads, n = 48, 4096
    codes = rng.integers(0, 4, (nreads, max_rl)).astype(np.uint8)
    lengths = rng.integers(width + 10, max_rl + 1, nreads).astype(np.int32)
    lengths[:8] = rng.integers(101, max_rl + 1, 8)  # longer than 100
    lengths[8:16] = rng.integers(width + 10, 100 - width + 1, 8)  # fit the pos-0 cap
    q1s = np.array([0, 10, 33, 60], np.int32)
    q1 = q1s[rng.integers(0, 4, n)]
    r = rng.integers(0, nreads, n).astype(np.int32)
    p = rng.integers(0, S, n).astype(np.int32)
    r[rng.random(n) < 0.05] = -1
    p[rng.random(n) < 0.05] = -1
    neg = rng.random(n) < 0.05  # the window starts before its read would
    p[neg] = rng.integers(0, 40, neg.sum())
    # Planted hits: the read is the target under its diagonal.
    for i in rng.integers(0, n, 300):
        rr, d = r[i], p[i] - q1[i]
        if rr >= 0 and d >= 0 and d + lengths[rr] <= S:
            codes[rr, : lengths[rr]] = tcat[d : d + lengths[rr]]
    # Position-0 hits: q1 == 0 at a gene start, with reads longer than 100
    # (the cap rejects them) and with reads that fit it.
    for j, i in enumerate(range(n - 24, n)):
        rr = j % 16
        p[i], q1[i], r[i] = gene_start[j % 4], 0, rr
        codes[rr, : lengths[rr]] = tcat[p[i] : p[i] + lengths[rr]]
    p[n - 40 : n - 24] = rng.integers(gene_start[-2], S, 16)  # the last gene
    budget = jverify.mismatch_budget_table(0.9, max_rl)
    rp = jpacked.pack_rows_np(codes)
    tp = jpacked.pack_stream(tcat)
    trows = np.asarray(jpacked.build_trows(tp, rp.shape[1], S))
    gb, steps = jpacked.build_gene_block(gene_start, S)

    exp = jpacked.verify_pairs_packed(
        jnp.asarray(r), jnp.asarray(p), jnp.asarray(rp), jnp.asarray(lengths), tp,
        jnp.asarray(gene_start), jnp.asarray(budget), jnp.asarray(q1), width,
        max_rl, S, trows=jnp.asarray(trows), gblock=jnp.asarray(gb), gsteps=steps,
    )
    got = tpacked.verify_pairs_packed(
        _t(r), _t(p), _t(rp), _t(lengths), _t(gene_start), _t(budget), _t(q1),
        width, max_rl, S, _t(trows), _t(gb), steps,
    )
    keep = np.asarray(exp[0])
    assert keep[: n - 40].sum() > 20 and keep[n - 24 :].any()
    assert not keep[n - 24 :][r[n - 24 :] < 8].any()  # the pos-0 cap
    for name, a, b in zip(("keep", "nx", "g", "s"), got, exp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


# ---- the streaming stage ---------------------------------------------------


@pytest.fixture(scope="module")
def probe(jax_workload, workload):
    """One probe (the JAX sort-merge probe's arrays) and both indexes."""
    q1s = (10, 30, 50, 70)
    rs, ts = workload
    ji = jindex.build_target_index(jax_workload[1], 20)
    ti = tindex.build_target_index(ts, 20, "cpu")
    rp = jpacked.pack_rows_np(rs.codes[:, :100])
    lengths = rs.lengths.astype(np.int32)
    pr = jfused._probe_windows_impl(
        jnp.asarray(rp), jnp.asarray(lengths), jnp.asarray(np.array(q1s, np.int32)),
        ji.skeys, width=20, min_dinuc=3,
    )
    return dict(ji=ji, ti=ti, rp=rp, lengths=lengths, q1s=q1s,
                pr=[np.asarray(x) for x in pr[:5]], total=int(pr[5]))


@pytest.mark.parametrize("surv_cap", [1 << 14, 1000], ids=["fits", "overflows"])
def test_expand_verify_stream_matches_jax(probe, surv_cap):
    """Several chunks of 512 lanes; survivor rows, in chunk order, and
    the survivor count must be equal, also when the count overflows the
    buffer and the rows past it are dropped."""
    s = probe
    ji, ti = s["ji"], s["ti"]
    nreads, nw = s["rp"].shape
    budget = jverify.mismatch_budget_table(0.96, 200)
    gb, steps = ji.gene_block()
    kw = dict(nreads=nreads, width=20, max_read_length=200, pair_chunk=512,
              surv_cap=surv_cap, smax=ji.num_bases, gsteps=steps)
    buf_j, nsurv_j, total_j, _ = jfused._expand_verify_impl(
        *(jnp.asarray(x) for x in s["pr"]), jnp.asarray(np.array(s["q1s"], np.int32)),
        jnp.asarray(s["rp"]), jnp.asarray(s["lengths"]), ji.spos, ji.tpacked,
        ji.gene_start, jnp.asarray(budget), ji.trows(nw), gb, **kw,
    )
    st = tfused._expand_verify_impl(
        *(_t(x) for x in s["pr"]), s["q1s"], _t(s["rp"]), _t(s["lengths"]),
        ti.spos, ti.gene_start, _t(budget), ti.trows(nw), ti.gene_block()[0],
        total=s["total"], **kw,
    )
    n = int(nsurv_j)
    assert int(total_j) == s["total"] > 20 * 512
    assert st.chunks == -(-s["total"] // 512)
    assert int(st.nsurv) == n > 1000
    assert (n > surv_cap) == (surv_cap == 1000)
    k = min(n, surv_cap)
    assert st.surv.shape == (surv_cap, tfused.NCOL)
    np.testing.assert_array_equal(st.surv.numpy()[:k], np.asarray(buf_j)[:k])


# ---- whole runs on the streaming path -------------------------------------


_STREAM_CASES = {
    "nodedup": dict(NoDedup=True, MaxPairChunk=4096),
    "32-windows": dict(windows=tuple(range(0, 64, 2))),
    "pair-cap": dict(),
    "surv-cap": dict(NoDedup=True, MaxPairChunk=4096),
}


@pytest.mark.parametrize("batch", [0, 2048], ids=["single-batch", "multibatch"])
@pytest.mark.parametrize("case", list(_STREAM_CASES))
def test_streaming_runs_match_jax(workload, jax_workload, case, batch, monkeypatch):
    """The streaming expand's MatchResult equals the JAX engine's: NoDedup,
    32 windows, ``_MAX_PAIR_CAP`` lowered below every batch's pair total
    in both packages, and the port's first survivor capacity lowered to
    64 (the JAX engine floors its capacity at 1 << 16), which re-runs the
    stage with the grown capacity.  The port runs each in one batch and
    in three; MaxMatches does not bind here, so the JAX engine's result
    does not depend on its batching and its single-batch run (through
    its streaming expand, with the same lowered cap) is the reference
    for both."""
    kw = _STREAM_CASES[case]
    cap = 1000 if case == "pair-cap" else None
    exp = _jax_result(jax_workload, _cfg(**kw), max_pair_cap=cap)
    if cap is not None:
        monkeypatch.setattr(tpipeline, "_MAX_PAIR_CAP", cap)
    if case == "surv-cap":
        monkeypatch.setattr(tpipeline, "_SURV_CAP0", 64)
        monkeypatch.setattr(tpipeline, "_CAP_HINT", [64])
    cfg = _cfg(batch=batch, **kw)
    rs, ts = workload
    index = tpipeline.build_target_index(ts, 20, "cpu")
    timings = {}
    got = tpipeline.run_matching_indexed(cfg, rs, index, timings=timings)
    _assert_same(got, exp)
    assert timings["chunks"] >= -(-timings["pairs"] // (cfg.MaxPairChunk or 1 << 17))
    if case == "surv-cap":
        monkeypatch.undo()
        unpatched = {}
        tpipeline.run_matching_indexed(cfg, rs, index, timings=unpatched)
        assert timings["chunks"] > unpatched["chunks"]  # a re-run
    if case == "nodedup":
        # The same as the dedup path's result.
        _assert_same(got, _jax_result(jax_workload, _cfg()))
