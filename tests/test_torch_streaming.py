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
from verify_pairs_cases import CASES, pair_args

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


@pytest.mark.parametrize("case", list(CASES))
def test_verify_pairs_packed_matches_jax(case):
    """The per-pair verify's twin (``verify_pairs_packed_torch``, which the
    wrapper runs on CPU tensors) against the JAX function on every case of
    tests/verify_pairs_cases.py: lanes in random order with a window
    offset each or one scalar, inactive lanes, negative diagonals,
    position-0 hits of reads longer than 100 and within the cap, the last
    gene and stream position, fixed in-word shifts, X codes, widths 8-40
    and reads of 4-512 words.  Every output of every lane must be equal."""
    args, tp = pair_args(case)
    r, p, rp, lengths, gene_start, budget, q1, width, max_rl, s, trows, gb, steps = args
    u32 = lambda t: t.numpy().view(np.uint32)  # noqa: E731
    exp = jpacked.verify_pairs_packed(
        jnp.asarray(r.numpy()), jnp.asarray(p.numpy()), jnp.asarray(u32(rp)),
        jnp.asarray(lengths.numpy()), jnp.asarray(tp), jnp.asarray(gene_start.numpy()),
        jnp.asarray(budget.numpy()), q1 if isinstance(q1, int) else jnp.asarray(q1.numpy()),
        width, max_rl, s, trows=jnp.asarray(u32(trows)), gblock=jnp.asarray(gb.numpy()),
        gsteps=steps,
    )
    before = tpacked.verify_pairs_packed.launches
    got = tpacked.verify_pairs_packed(*args)
    assert tpacked.verify_pairs_packed.launches == before  # the CPU runs the twin
    assert [a.dtype for a in got] == [torch.bool] + [torch.int32] * 3
    for name, a, b in zip(("keep", "nx", "g", "s"), got, exp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    keep, n = got[0].numpy(), r.shape[0]
    if n < 1024:  # a case of a few lanes (the tile edges): its lanes are all checked above
        return
    assert keep[: n - 64].sum() > 20
    if not (isinstance(q1, int) and q1):  # the last 24 lanes: q1 == 0 at gene starts
        assert keep[n - 24:].any()
        if max_rl > 100:
            assert not keep[n - 24:][r.numpy()[n - 24:] < 8].any()  # the pos-0 cap


def _nib_mask(k: int) -> int:
    k = min(max(k, 0), 8)
    return (1 << (4 * k)) - 1


def _stage_run_model(src, keys, at, words, stride, live):
    """csrc/verify.cu's stage_run for one warp: each of its 32 threads
    takes ``words`` turns of the flat run (word f of the run is word f %
    words of row f / words, whose source src[at(keys[row]) + word] the
    shuffle gives), copying into rows ``stride`` words apart only rows
    below ``live``.  Returns the staged words and how often each slot was
    written."""
    staged = np.zeros(32 * stride, np.int64)
    wrote = np.zeros(32 * stride, np.int64)
    step_rows, step_words = 32 // words, 32 % words
    for lane in range(32):
        row, word = lane // words, lane % words
        for _ in range(lane, 32 * words, 32):
            if row < live:
                staged[row * stride + word] = src[at(int(keys[row])) + word]
                wrote[row * stride + word] += 1
            row += step_rows
            word += step_words
            if word >= words:
                word -= words
                row += 1
    return staged, wrote


def _pairs_model(r, p, rpacked, lengths, gene_start, budget, q1, width, max_rl, smax,
                 trows, gblock, steps):
    """csrc/verify.cu's staged B10 in numpy integers, a warp of 32 lanes at
    a time: each warp's read rows and target windows (the lane's nwords +
    1 words of its trows row from word (dc >> 3) & 7) staged by the flat
    runs of stage_run at strides nwords | 1 and (nwords + 1) | 1, every
    word of a live lane's rows written once and nothing past the live
    lanes; then per lane the gene found from the two gblock bounds and
    ``steps`` refines, the aligned word (next:prev) >> rshift from the
    staged window with the previous word carried, and a window count of
    the lane's one window over the staged read row."""
    nreads, nwords = rpacked.shape
    ntrows, tcols = trows.shape
    tflat, rflat = trows.view(np.uint32).ravel(), rpacked.view(np.uint32).ravel()
    glast, nblock, n = len(gene_start) - 1, len(gblock), len(r)
    q1 = np.broadcast_to(np.asarray(q1, np.int64), (n,))
    clamp = lambda x, a, b: min(max(int(x), a), b)  # noqa: E731
    rstride, tstride = nwords | 1, (nwords + 1) | 1
    out = np.zeros((4, n), np.int64)
    for j0 in range(0, n, 32):
        live = min(32, n - j0)
        lanes = range(j0, j0 + live)
        rc = [clamp(r[j], 0, nreads - 1) for j in lanes] + [0] * (32 - live)
        dc = [max(clamp(p[j], 0, smax - 1) - int(q1[j]), 0) for j in lanes] + [0] * (32 - live)
        tkey = [(clamp(d >> 6, 0, ntrows - 1) << 3) | ((d >> 3) & 7) for d in dc]
        s_r, wr = _stage_run_model(rflat, rc, lambda k: k * nwords, nwords, rstride, live)
        s_t, wt = _stage_run_model(tflat, tkey, lambda k: (k >> 3) * tcols + (k & 7),
                                   nwords + 1, tstride, live)
        for wrote, words, stride in ((wr, nwords, rstride), (wt, nwords + 1, tstride)):
            rows = wrote.reshape(32, stride)
            assert (rows[:live, :words] == 1).all() and not rows[:live, words:].any()
            assert not rows[live:].any()
        for i, j in enumerate(lanes):
            pc, q = clamp(p[j], 0, smax - 1), int(q1[j])
            rlen = int(lengths[rc[i]])
            lo = int(gblock[clamp(pc >> 8, 0, nblock - 1)])
            hi = int(gblock[clamp((pc >> 8) + 1, 0, nblock - 1)])
            for _ in range(steps):
                mid = (lo + hi + 1) >> 1
                if gene_start[clamp(mid, 0, glast)] <= pc:
                    lo = mid
                else:
                    hi = mid - 1
            gs = int(gene_start[clamp(lo, 0, glast)])
            glen = int(gene_start[clamp(lo + 1, 0, glast)]) - gs
            pl, q2 = pc - gs, q + width
            cap = 100 - q2 if pl == 0 and q == 0 else pl + width + max_rl - q2
            fit = rlen - q2 <= min(glen, cap) - (pl + width)
            t, rw = s_t[i * tstride:], s_r[i * rstride:]
            prev, nx, win = int(t[0]), 0, 0
            for w in range(nwords):
                nxt = int(t[w + 1])
                x = ((((nxt << 32) | prev) >> ((dc[i] & 7) * 4)) & 0xFFFFFFFF) ^ int(rw[w])
                prev = nxt
                x &= _nib_mask(rlen - 8 * w)
                nz = (x | x >> 1 | x >> 2 | x >> 3) & 0x11111111
                nx += bin(nz).count("1")
                win += bin(nz & _nib_mask(q2 - 8 * w) & ~_nib_mask(q - 8 * w)).count("1")
            bud = int(budget[clamp(rlen, 0, len(budget) - 1)])
            keep = r[j] >= 0 and p[j] >= 0 and pl - q >= 0 and fit and win == 0 and nx <= bud
            out[:, j] = keep, nx, lo, pl - q
    return out


@pytest.mark.parametrize("case", ["0", "w20-scalar-q1", "w8-32win-10words", "rshift-28",
                                  "w20-19-lanes", "w20-dead-warps", "w20-shared-rows",
                                  "w20-512words-tile-edges"])
def test_verify_pairs_kernel_model_matches_twin(case):
    """The twin equals a numpy model of B10's staged kernel on every lane
    (the kernel itself runs only on the card, test_torch_verify_pairs_cuda.py)."""
    args, _ = pair_args(case, n=600)
    twin = tpacked.verify_pairs_packed_torch(*args)
    model = _pairs_model(*(x.numpy() if torch.is_tensor(x) else x for x in args))
    for name, a, b in zip(("keep", "nx", "g", "s"), twin, model):
        np.testing.assert_array_equal(a.numpy().astype(np.int64), b, err_msg=name)


def test_verify_pairs_wrapper_refuses_mixed_devices():
    """A tensor off the CPU never reaches the twin: the wrapper raises, and
    counts no launch."""
    args, _ = pair_args("w20-4win-13words", n=300)
    meta = [x.to("meta") if torch.is_tensor(x) and i == 2 else x for i, x in enumerate(args)]
    before = tpacked.verify_pairs_packed.launches
    with pytest.raises(ValueError):
        tpacked.verify_pairs_packed(*meta)
    assert tpacked.verify_pairs_packed.launches == before


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
