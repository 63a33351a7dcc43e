"""The port's stage functions (muscato_tpu_torch/ops/{fused,packed}.py and
the index) against their JAX counterparts in muscato_tpu, on the same
inputs made with numpy from a seed.

Integer outputs must be exactly equal.  Where a JAX sort is unstable (the
probe's query and compaction sorts, the survivor sort) the tie order is
not part of the contract, and those intermediates are compared as
multisets of rows.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from muscato_tpu.bench import gendat as jgendat
from muscato_tpu.engine import index as jindex
from muscato_tpu.ops import fused as jfused
from muscato_tpu.ops import packed as jpacked
from muscato_tpu.ops import verify as jverify
from muscato_tpu_torch.bench import gendat as tgendat
from muscato_tpu_torch.engine import index as tindex
from muscato_tpu_torch.ops import fused as tfused
from muscato_tpu_torch.ops import packed as tpacked
from muscato_tpu_torch.ops import verify as tverify
from muscato_tpu_torch.ops import window_queries as twq
from muscato_tpu_torch.ops import windows as twindows


def _t(a) -> torch.Tensor:
    a = np.array(a)  # a writable copy (jax arrays are read-only)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _u32(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


def _reads(rng, nreads, lmax):
    codes = rng.integers(0, 5, (nreads, lmax)).astype(np.uint8)  # incl. X
    lengths = rng.integers(0, lmax + 1, nreads).astype(np.int32)
    lengths[: nreads // 2] = lmax
    for i in range(nreads):
        codes[i, lengths[i]:] = 0
    return codes, lengths


def test_host_constants_match():
    from muscato_tpu.ops import windows as jwin

    for w in (4, 10, 13, 14, 20, 31):
        assert int(twindows.key_multiplier(w)) == int(jwin.key_multiplier(w))
        assert twindows.uses_second_key(w) == jwin.uses_second_key(w)
    for pm, ml in ((0.96, 200), (0.9, 37), (1.0, 10), (0.5, 120)):
        np.testing.assert_array_equal(
            tverify.mismatch_budget_table(pm, ml), jverify.mismatch_budget_table(pm, ml)
        )


def test_uint32_helpers_match_numpy():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 2**32, 5000, dtype=np.uint64)
    xt = torch.from_numpy(x.astype(np.int64))
    pc = np.array([bin(int(v)).count("1") for v in x])
    np.testing.assert_array_equal(tpacked.popcount32(xt).numpy(), pc)
    for mult in (5, 0x9E3779B1, 0x85EBCA77, 0xFFFFFFFF):
        exp = (x * np.uint64(mult)) & np.uint64(0xFFFFFFFF)
        np.testing.assert_array_equal(tpacked.mulmod32(xt, mult).numpy(), exp.astype(np.int64))
    np.testing.assert_array_equal(
        tpacked.to_i32(xt).numpy(), x.astype(np.uint32).view(np.int32)
    )


@pytest.mark.parametrize("lmax", [1, 8, 37, 100, 200])
def test_pack_rows_matches_jax(lmax):
    codes, _ = _reads(np.random.default_rng(lmax), 257, lmax)
    exp = jpacked.pack_rows_np(codes)
    got = tpacked.pack_rows(torch.from_numpy(codes))
    assert got.dtype == torch.int32 and got.shape == exp.shape
    np.testing.assert_array_equal(_u32(got), exp)


@pytest.mark.parametrize("width,min_dinuc", [(10, 0), (10, 2), (20, 0), (20, 2)])
def test_window_queries_match_jax(width, min_dinuc):
    rng = np.random.default_rng(width * 10 + min_dinuc)
    codes, lengths = _reads(rng, 300, 100)
    # Windows straddle word boundaries; 90 lies past the last full slice,
    # so its keys are the clipped-slice garbage of an invalid window.
    q1s = (0, 3, 8, 30, 77, 90)
    rp = jpacked.pack_rows_np(codes)
    k1, k2, v = jfused._window_queries(
        jnp.asarray(rp), jnp.asarray(lengths), jnp.asarray(np.array(q1s, np.int32)),
        width=width, min_dinuc=min_dinuc,
    )
    t1, t2, tv = twq.window_queries_torch(
        _t(rp), _t(lengths), q1s, width=width, min_dinuc=min_dinuc
    )
    np.testing.assert_array_equal(tv.numpy(), np.asarray(v))
    np.testing.assert_array_equal(_u32(t1), np.asarray(k1))
    np.testing.assert_array_equal(_u32(t2), np.asarray(k2))


def test_pack64_extract64_match_jax():
    rng = np.random.default_rng(2)
    bits = (22, 17, 21, 4)
    fields = [rng.integers(0, 1 << b, 1000).astype(np.int32) for b in bits]
    jlo, jhi = jfused._pack64_fields([jnp.asarray(f) for f in fields], bits)
    tlo, thi = tfused._pack64_fields([_t(f) for f in fields], bits)
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo).astype(np.int64))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi).astype(np.int64))
    pos = 0
    for f, b in zip(fields, bits):
        got = tfused._extract64(tlo, thi, pos, b).numpy()
        np.testing.assert_array_equal(got, np.asarray(jfused._extract64(jlo, jhi, pos, b)))
        np.testing.assert_array_equal(got, f)
        pos += b


def _index_pair(workload, width):
    """The same targets compiled by both packages, each from its own
    TargetSet (the port's on the CPU)."""
    return (
        jindex.build_target_index(workload["jax"][1], width),
        tindex.build_target_index(workload["port"][1], width, "cpu"),
    )


@pytest.fixture(scope="module")
def workload():
    """The same seeded workload made by each package's gendat."""
    args = (1500, 100, 60, 1000)
    return {
        "jax": jgendat.generate_arrays_realistic(*args, seed=3),
        "port": tgendat.generate_arrays_realistic(*args, seed=3),
    }


def test_index_build_matches_jax(workload):
    ji, ti = _index_pair(workload, 20)
    np.testing.assert_array_equal(_u32(ti.skeys), np.asarray(ji.skeys))
    np.testing.assert_array_equal(ti.spos.numpy(), np.asarray(ji.spos))
    np.testing.assert_array_equal(_u32(ti.tpacked), np.asarray(ji.tpacked))
    np.testing.assert_array_equal(ti.gene_start.numpy(), np.asarray(ji.gene_start))
    for nwords in (13, 4):
        np.testing.assert_array_equal(_u32(ti.trows(nwords)), np.asarray(ji.trows(nwords)))
    gb, steps = ti.gene_block()
    jgb, jsteps = ji.gene_block()
    assert steps == jsteps
    np.testing.assert_array_equal(gb.numpy(), np.asarray(jgb))


def test_gene_lookup_matches_jax():
    rng = np.random.default_rng(4)
    gene_start = np.concatenate([[0], np.cumsum(rng.integers(1, 700, 300))]).astype(np.int32)
    smax = int(gene_start[-1])
    gb, steps = tpacked.build_gene_block(gene_start, smax)
    p = np.sort(rng.integers(0, smax, 4000)).astype(np.int32)
    g_j = jpacked.gene_of_pos_block(
        jnp.asarray(gene_start), jnp.asarray(gb), jnp.asarray(p), steps
    )
    g, gs, ge = tpacked.gene_of_pos_block_mono(_t(gene_start), _t(gb), _t(p), steps)
    np.testing.assert_array_equal(g.numpy(), np.asarray(g_j))
    np.testing.assert_array_equal(gs.numpy(), gene_start[np.asarray(g_j)])
    np.testing.assert_array_equal(ge.numpy(), gene_start[np.asarray(g_j) + 1])


def test_verify_diagonals_packed_matches_jax():
    """(d, r)-sorted lanes incl. negative diagonals in front, inactive lanes
    at the end, pos-0 windows and several genes."""
    rng = np.random.default_rng(9)
    max_rl, width, S = 64, 8, 4000
    gene_start = np.array([0, 1500, 2600, S], np.int32)
    tcat = rng.integers(0, 4, S).astype(np.uint8)
    codes = rng.integers(0, 4, (32, max_rl)).astype(np.uint8)
    lengths = rng.integers(width + 20, max_rl + 1, 32).astype(np.int32)
    n = 1024
    d = np.sort(rng.integers(0, S - max_rl, n)).astype(np.int32)
    d[:5] = [-7, -3, -3, -1, 0]
    d[5:9] = [1500, 1500, 2600, 2600]  # read starts at a gene start
    r = rng.integers(0, 32, n).astype(np.int32)
    r[-37:] = -1
    # Some lanes really match: copy the target under their diagonal.
    for i in rng.integers(9, n - 37, 60):
        codes[r[i], : lengths[r[i]]] = tcat[d[i] : d[i] + lengths[r[i]]]
    q1s = (0, 10, 21)
    budget = jverify.mismatch_budget_table(0.9, max_rl)
    rp = jpacked.pack_rows_np(codes)
    tp = jpacked.pack_stream(tcat)
    trows = jpacked.build_trows(tp, rp.shape[1], S)
    gb, steps = jpacked.build_gene_block(gene_start, S)

    exp = jpacked.verify_diagonals_packed(
        jnp.asarray(r), jnp.asarray(d), jnp.asarray(rp), jnp.asarray(lengths),
        tp, jnp.asarray(gene_start), jnp.asarray(budget),
        jnp.asarray(np.array(q1s, np.int32)), width, max_rl, S,
        trows=trows, gblock=jnp.asarray(gb), gsteps=steps, dorder=True,
    )
    got = tpacked.verify_diagonals_packed(
        _t(r), _t(d), _t(rp), _t(lengths), _t(gene_start), _t(budget), q1s,
        width, S, _t(np.asarray(trows)), _t(gb), steps,
    )
    assert np.asarray(exp[3]).any()
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(exp[3]))
    act = (r >= 0) & (d >= 0)
    for a, b in zip(got[:3], exp[:3]):
        np.testing.assert_array_equal(a.numpy()[act], np.asarray(b)[act])


def _stage_inputs(workload, width, q1s, min_dinuc):
    rs, _ts = workload["port"]
    ji, ti = _index_pair(workload, width)
    rp = jpacked.pack_rows_np(rs.codes[:, :100])
    nreads = rp.shape[0]
    return ji, ti, rp, rs.lengths.astype(np.int32), nreads


def _slots(counts, lo, qid):
    counts, lo, qid = (np.asarray(x) for x in (counts, lo, qid))
    act = counts > 0
    assert not act[act.sum():].any(), "active slots must form a prefix"
    assert (np.diff(lo[act]) >= 0).all(), "active slots are in lo order"
    return sorted(zip(counts[act].tolist(), lo[act].tolist(), qid[act].tolist()))


@pytest.mark.parametrize("width,min_dinuc", [(20, 3), (10, 0)])
def test_probe_matches_jax(workload, width, min_dinuc):
    q1s = (10, 30, 50, 70)
    ji, ti, rp, lengths, nreads = _stage_inputs(workload, width, q1s, min_dinuc)
    rp, lengths = rp[:256], lengths[:256]  # 4 x 256 queries: one join block
    exp = jfused._probe_windows_pjoin_impl(
        jnp.asarray(rp), jnp.asarray(lengths), jnp.asarray(np.array(q1s, np.int32)),
        ji.skeys, width=width, min_dinuc=min_dinuc, interpret=True,
        window_rows=ji.skeys.shape[0] // 128 + 1,  # one window spans the index
    )
    got = tfused._probe_windows_pjoin_impl(
        _t(rp), _t(lengths), q1s, ti.skeys, width=width, min_dinuc=min_dinuc
    )
    assert int(got.total) == int(exp[5]) > 0
    np.testing.assert_array_equal(_u32(got.keyf), np.asarray(exp[3]))
    np.testing.assert_array_equal(_u32(got.key2f), np.asarray(exp[4]))
    assert _slots(got.counts, got.lo, got.qid) == _slots(exp[0], exp[1], exp[2])


@pytest.mark.parametrize("width,min_dinuc", [(20, 3), (10, 0), (14, 2)])
def test_sort_merge_probe_matches_jax(workload, width, min_dinuc):
    """The port's sort-merge probe (MUSCATO_PJOIN=0) against the JAX
    package's: query keys exact, active slots equal as a multiset (the
    compaction sort is unstable in both)."""
    q1s = (10, 30, 50, 70)
    ji, ti, rp, lengths, nreads = _stage_inputs(workload, width, q1s, min_dinuc)
    exp = jfused._probe_windows_impl(
        jnp.asarray(rp), jnp.asarray(lengths), jnp.asarray(np.array(q1s, np.int32)),
        ji.skeys, width=width, min_dinuc=min_dinuc,
    )
    got = tfused._probe_windows_impl(
        _t(rp), _t(lengths), q1s, ti.skeys, width=width, min_dinuc=min_dinuc
    )
    assert got.counts.shape == (len(q1s) * nreads,)
    assert int(got.total) == int(exp[5]) > 0
    np.testing.assert_array_equal(_u32(got.keyf), np.asarray(exp[3]))
    np.testing.assert_array_equal(_u32(got.key2f), np.asarray(exp[4]))
    assert _slots(got.counts, got.lo, got.qid) == _slots(exp[0], exp[1], exp[2])
    # The sorted-join probe resolves the same slots.
    pj = tfused._probe_windows_pjoin_impl(
        _t(rp), _t(lengths), q1s, ti.skeys, width=width, min_dinuc=min_dinuc
    )
    assert _slots(pj.counts, pj.lo, pj.qid) == _slots(got.counts, got.lo, got.qid)


@pytest.fixture(scope="module")
def stages(workload):
    """Probe (JAX sort-merge) and expand inputs shared by the stage tests."""
    q1s = (10, 30, 50, 70)
    width = 20
    ji, ti, rp, lengths, nreads = _stage_inputs(workload, width, q1s, 3)
    pr = jfused._probe_windows_impl(
        jnp.asarray(rp), jnp.asarray(lengths), jnp.asarray(np.array(q1s, np.int32)),
        ji.skeys, width=width, min_dinuc=3,
    )
    total = int(pr[5])
    return dict(ji=ji, ti=ti, rp=rp, lengths=lengths, nreads=nreads, q1s=q1s,
                width=width, pr=pr, total=total)


@pytest.mark.parametrize("packed_minor", [True, False])
def test_expand_pairs_match_jax(stages, packed_minor):
    s = stages
    pair_cap = s["total"] + 1000
    smax = s["ti"].num_bases if packed_minor else None
    counts, lo, qid = (np.asarray(x) for x in s["pr"][:3])
    exp = jfused._expand_pairs_impl(
        jnp.asarray(counts), jnp.asarray(lo), jnp.asarray(qid),
        jnp.asarray(np.array(s["q1s"], np.int32)), s["ji"].spos,
        nreads=s["nreads"], pair_cap=pair_cap, dorder=True, smax=smax,
        max_read_length=200,
    )
    got = tfused._expand_pairs_impl(
        _t(counts), _t(lo), _t(qid), s["q1s"], s["ti"].spos,
        nreads=s["nreads"], pair_cap=pair_cap, smax=smax,
    )
    nu = int(exp[4])
    assert int(got.nuniq) == nu > 0 and int(got.total) == int(exp[5])
    np.testing.assert_array_equal(got.ur.numpy(), np.asarray(exp[2]))
    np.testing.assert_array_equal(got.ud.numpy(), np.asarray(exp[3]))

    def lanes(q, u):
        q, u = np.asarray(q), np.asarray(u)
        return sorted(zip(q[q >= 0].tolist(), u[q >= 0].tolist()))

    assert lanes(got.qid_s, got.u_idx) == lanes(exp[0], exp[1])


def test_verify_tail_matches_jax(stages):
    """Both verify+tail ports get the JAX expansion and a small vchunk (so
    the chunk loop runs several times); survivors compare as multisets."""
    s = stages
    ji, ti = s["ji"], s["ti"]
    pair_cap = s["total"] + 1000
    q1s_j = jnp.asarray(np.array(s["q1s"], np.int32))
    ex = jfused._expand_pairs_impl(
        *s["pr"][:3], q1s_j, ji.spos, nreads=s["nreads"], pair_cap=pair_cap,
        dorder=True, smax=ji.num_bases, max_read_length=200,
    )
    budget = jverify.mismatch_budget_table(0.96, 200)
    trows = ji.trows(s["rp"].shape[1])
    gb, steps = ji.gene_block()
    kw = dict(nreads=s["nreads"], width=s["width"], max_read_length=200,
              vchunk=512, surv_cap=1 << 14, smax=ji.num_bases, gsteps=steps)
    surv_j, nsurv_j, _, _ = jfused._verify_diagonals_impl(
        *ex[:5], s["pr"][3], s["pr"][4], q1s_j, jnp.asarray(s["rp"]),
        jnp.asarray(s["lengths"]), ji.tpacked, ji.gene_start, jnp.asarray(budget),
        trows, gb, dorder=True, **kw,
    )
    pairs = tfused.Pairs(*(_t(np.asarray(x)) for x in ex[:5]), torch.tensor(0))
    surv_cap = kw.pop("surv_cap")
    ver = tfused._verify_diagonals(
        pairs, s["q1s"], _t(s["rp"]), _t(s["lengths"]), ti.gene_start,
        _t(budget), ti.trows(s["rp"].shape[1]), ti.gene_block()[0], **kw,
    )
    surv = tfused.survivor_rows(
        ver, _t(np.asarray(s["pr"][3])), _t(np.asarray(s["pr"][4])),
        nreads=s["nreads"], nwin=len(s["q1s"]), surv_cap=surv_cap,
    )
    n = int(nsurv_j)
    assert int(ver.nsurv) == n > 0
    rows = lambda a: sorted(map(tuple, np.asarray(a)[:n].tolist()))  # noqa: E731
    assert rows(surv.numpy()) == rows(surv_j)


def _rank_buf(seed):
    rng = np.random.default_rng(100 + seed)
    n = 2048
    bits = [(22, 17, 21, 4), (20, 20, 20, 4), (10, 10, 10, 4)][seed % 3]
    rb, gb, sb, xb = bits
    r = rng.integers(0, min(1 << rb, 37), n).astype(np.int32)
    g = rng.integers(0, min(1 << gb, 11), n).astype(np.int32)
    s = rng.integers(0, min(1 << sb, 23), n).astype(np.int32)
    r64, g64, s64 = (v.astype(np.int64) for v in (r, g, s))
    nx = ((r64 * 2654435761 + g64 * 40503 + s64 * 2246822519) % (1 << xb)).astype(np.int32)
    grp = rng.choice(np.array([-2**31, -7, 0, 5, 2**31 - 1], dtype=np.int32), n)
    grp2 = rng.choice(np.array([-1, 0, 9], dtype=np.int32), n)
    win = rng.integers(0, 3, n).astype(np.int32)
    live = rng.random(n) < 0.85
    return np.stack([r, g, s, nx, grp, grp2, win], axis=1), live, bits


@pytest.mark.parametrize("seed", range(3))
def test_rank_core_matches_jax(seed):
    """Packed rank (the single-batch path) and unpacked rank with and
    without the group columns, for both match modes and binding caps:
    the retained rows must be bit-equal to the JAX rank's."""
    buf, live, bits = _rank_buf(seed)
    jb, jl = jnp.asarray(buf), jnp.asarray(live)
    tb, tl = _t(buf), torch.from_numpy(live)
    for mode in ("best", "first"):
        for mm, mmtol in ((1, 0), (2, 1), (3, 2)):
            for full_cols, pb in ((False, bits), (False, None), (True, None)):
                exp, en = jfused._rank_core(
                    jb, jl, jnp.int32(mm), jnp.int32(mmtol), match_mode=mode,
                    full_cols=full_cols, pack_bits=pb,
                )
                got, gn = tfused._rank_core(
                    tb, tl, mm, mmtol, match_mode=mode, full_cols=full_cols,
                    pack_bits=pb,
                )
                n = int(en)
                assert int(gn) == n > 0
                # Group columns of full_cols rows ride an unstable JAX sort;
                # (read, gene, start, nmiss) are what the contract fixes.
                ncmp = 4 if full_cols else None
                np.testing.assert_array_equal(
                    got.numpy()[:n, :ncmp], np.asarray(exp)[:n, :ncmp],
                    err_msg=f"{mode} mm={mm} mmtol={mmtol} cols={full_cols} bits={pb}",
                )


def test_port_imports_no_jax():
    """Importing every module of muscato_tpu_torch, and chip_smoke, in a
    fresh interpreter leaves jax and every module of muscato_tpu
    unimported (tests/test_torch_isolation.py scans the sources)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import muscato_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'muscato_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('muscato_tpu_torch')]))\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=root,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25
