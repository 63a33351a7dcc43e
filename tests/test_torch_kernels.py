"""The port's kernels (muscato_tpu_torch/ops/{join,expand,gather,
window_queries}.py) against the JAX package's numpy oracles, XLA functions
and Pallas kernels.

On the CPU each wrapper runs its plain PyTorch twin; the Pallas functions
run in interpret mode at one or two blocks (interpret mode is slow).  The
CUDA kernels themselves are checked against the twins by the tests marked
``gpu``, which skip without a card.  All outputs are integers and must be
exactly equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from muscato_tpu.ops import fused as jfused
from muscato_tpu.ops import packed as jpacked
from muscato_tpu.ops import pallas_expand as pe
from muscato_tpu.ops import pallas_gather as pg
from muscato_tpu.ops import pallas_join as pj
from muscato_tpu.ops import pallas_windows as pw
from muscato_tpu_torch.ops import _lib, expand, gather, join, window_queries


def _t(a: np.ndarray) -> torch.Tensor:
    """numpy int32/uint32 -> int32 tensor of the same bytes."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _join_case(rng, v, q, top=True):
    """Sorted uint32 index with duplicate runs, and nondecreasing queries
    that hit runs, miss, and sit at both ends.  top=True adds 0xFFFFFFFF
    keys and queries (the Pallas join reports those as a window overflow,
    since its pad keys are 0xFFFFFFFF too)."""
    hi = 2**32 if top else 2**32 - 1
    keys = rng.integers(0, hi, v, dtype=np.uint64).astype(np.uint32)
    nrun = max(1, v // 10)
    keys[rng.integers(0, v, nrun)] = keys[rng.integers(0, v, nrun)]
    if top:
        keys[-max(1, v // 50):] = 0xFFFFFFFF
    keys = np.sort(keys)
    qs = np.concatenate([
        rng.choice(keys, q // 2),
        rng.integers(0, hi, q - q // 2 - 2, dtype=np.uint64).astype(np.uint32),
        np.array([0, hi - 1], np.uint32),
    ])
    return keys, np.sort(qs)


def _slots_case(rng, m, live_frac=0.7, maxc=6):
    """Compacted probe slots: a live prefix of count > 0 slots, then a dead
    tail; oexcl is the exclusive prefix sum."""
    nlive = int(m * live_frac)
    counts = np.zeros(m, np.int32)
    counts[:nlive] = rng.integers(1, maxc, nlive)
    oexcl = (np.cumsum(counts) - counts).astype(np.int32)
    lo = rng.integers(0, 50_000, m).astype(np.int32)
    qid = rng.permutation(m).astype(np.int32)
    qid[nlive:] = -1
    return oexcl, lo, qid, int(counts.sum())


def _monotone_idx(rng, n, m):
    """Piecewise nondecreasing indices into [0, n): ascending runs with
    step-backs (one postings run re-expanded for several queries)."""
    parts, left = [], m
    while left:
        k = min(left, int(rng.integers(1, 400)))
        start = int(rng.integers(0, n))
        parts.append(np.minimum(start + np.cumsum(rng.integers(0, 3, k)), n - 1))
        left -= k
    idx = np.concatenate(parts).astype(np.int32)
    return np.sort(idx) if rng.random() < 0.5 else idx


@pytest.mark.parametrize("seed", range(6))
def test_sorted_join_twin_matches_numpy(seed):
    rng = np.random.default_rng(seed)
    keys, qs = _join_case(rng, int(rng.integers(1, 5000)), int(rng.integers(3, 3000)))
    lo, cnt, of = join.sorted_join(_t(keys), _t(qs))
    lo_np, cnt_np = pj.sorted_join_np(keys, qs)
    assert of == 0
    np.testing.assert_array_equal(lo.numpy(), lo_np)
    np.testing.assert_array_equal(cnt.numpy(), cnt_np)


def test_sorted_join_twin_matches_pallas():
    rng = np.random.default_rng(11)
    keys, qs = _join_case(rng, 3000, 2000, top=False)  # two blocks
    lo_p, cnt_p, of_p = pj.sorted_join(
        jnp.asarray(keys), jnp.asarray(qs), interpret=True
    )
    lo, cnt, _ = join.sorted_join(_t(keys), _t(qs))
    assert int(of_p) == 0
    np.testing.assert_array_equal(lo.numpy(), np.asarray(lo_p))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_p))


@pytest.mark.parametrize("seed", range(6))
def test_expand_owners_twin_matches_numpy(seed):
    rng = np.random.default_rng(100 + seed)
    m = int(rng.integers(1, 3000))
    oexcl, lo, qid, total = _slots_case(rng, m, live_frac=rng.random())
    pair_cap = total + int(rng.integers(0, 500))
    q_np, s_np = pe.expand_owners_np(oexcl, lo, qid, pair_cap)
    q, s = expand.expand_owners(_t(oexcl), _t(lo), _t(qid), pair_cap=pair_cap)
    np.testing.assert_array_equal(q.numpy(), q_np)
    np.testing.assert_array_equal(s.numpy(), s_np)


def test_expand_owners_twin_matches_pallas():
    rng = np.random.default_rng(7)
    oexcl, lo, qid, total = _slots_case(rng, 1500, live_frac=0.8, maxc=5)
    pair_cap = pe.BLOCK  # one kernel block
    assert total <= pair_cap
    q_p, s_p = pe.expand_owners(
        jnp.asarray(oexcl), jnp.asarray(lo), jnp.asarray(qid),
        pair_cap=pair_cap, interpret=True,
    )
    q, s = expand.expand_owners(_t(oexcl), _t(lo), _t(qid), pair_cap=pair_cap)
    live = np.arange(pair_cap) < total  # the lanes the contract specifies
    np.testing.assert_array_equal(q.numpy()[live], np.asarray(q_p)[live])
    np.testing.assert_array_equal(s.numpy()[live], np.asarray(s_p)[live])


def _sub_trial(trial):
    """Trial ``trial`` of the JAX package's sub-chunked expand test
    (tests/test_pallas.py::test_expand_owners_matches_oracle): random
    counts with interior empty slots, one slot owning everything, and an
    empty second half."""
    rng = np.random.default_rng(1)
    for t in range(trial + 1):
        m = int(rng.integers(1, 40000))
        counts = rng.integers(0, 6, m).astype(np.int32)
        if t == 1:
            counts[:] = 0
            counts[0] = 777
        if t == 2:
            counts[m // 2:] = 0
        oexcl = (np.cumsum(counts) - counts).astype(np.int32)
        total = int(counts.sum())
        lo = rng.integers(0, 1 << 20, m).astype(np.int32)
        qid = rng.integers(0, 1 << 24, m).astype(np.int32)
        cap = max(8192, 1 << int(np.ceil(np.log2(max(total, 2)))))
    return oexcl, lo, qid, total, cap


@pytest.mark.parametrize("trial", range(5))
def test_expand_owners_sub_twin_matches_pallas(trial):
    """expand_owners(subchunk=True) against the sub-chunked Pallas kernel
    on the active lanes and the numpy oracle on every lane."""
    oexcl, lo, qid, total, cap = _sub_trial(trial)
    q, s = expand.expand_owners(_t(oexcl), _t(lo), _t(qid), pair_cap=cap,
                                subchunk=True)
    q_np, s_np = pe.expand_owners_np(oexcl, lo, qid, cap)
    np.testing.assert_array_equal(q.numpy(), q_np)
    np.testing.assert_array_equal(s.numpy(), s_np)
    q_p, s_p = pe.expand_owners(
        jnp.asarray(oexcl), jnp.asarray(lo), jnp.asarray(qid), pair_cap=cap,
        interpret=True, subchunk=True,
    )
    np.testing.assert_array_equal(q.numpy()[:total], np.asarray(q_p)[:total])
    np.testing.assert_array_equal(s.numpy()[:total], np.asarray(s_p)[:total])


def _wq_reads(rng, nreads, lmax):
    """Codes 0-4 (X included) with zero tails past each read's length."""
    codes = rng.integers(0, 5, (nreads, lmax)).astype(np.uint8)
    lengths = rng.integers(0, lmax + 1, nreads).astype(np.int32)
    lengths[: nreads // 2] = lmax
    codes[np.arange(lmax)[None, :] >= lengths[:, None]] = 0
    return codes, lengths


def _unpack(rp: np.ndarray) -> np.ndarray:
    """(R, nw) uint32 nibble-packed words -> (R, 8*nw) uint8 codes."""
    shifts = np.arange(8, dtype=np.uint32) * 4
    return ((rp[:, :, None] >> shifts) & 0xF).astype(np.uint8).reshape(len(rp), -1)


# Windows straddle word boundaries; at widths above 10, 90 runs past the
# 100-base rows (its keys are the clipped slice's, on an invalid lane).
WQ_WINDOWS = (0, 3, 8, 30, 77, 90)


@pytest.mark.parametrize("min_dinuc", [0, 3])
@pytest.mark.parametrize("width", [4, 8, 13, 14, 20])
def test_window_queries_twin_matches_jax(width, min_dinuc):
    """B5's twin against the JAX package's three window-query functions:
    the packed XLA function on every lane, the byte-matrix XLA function
    and the Pallas kernel (interpret mode) with valid exact and keys
    where valid."""
    rng = np.random.default_rng(width * 10 + min_dinuc)
    codes, lengths = _wq_reads(rng, 300, 100)
    rp = jpacked.pack_rows_np(codes)
    q1s = WQ_WINDOWS
    k1, k2, v = window_queries.window_queries(
        _t(rp), _t(lengths), q1s, width=width, min_dinuc=min_dinuc
    )
    k1, k2, v = k1.numpy().view(np.uint32), k2.numpy().view(np.uint32), v.numpy()
    q1j = jnp.asarray(np.array(q1s, np.int32))
    kw = dict(width=width, min_dinuc=min_dinuc)

    e1, e2, ev = jfused._window_queries(jnp.asarray(rp), jnp.asarray(lengths), q1j, **kw)
    np.testing.assert_array_equal(v, np.asarray(ev))
    np.testing.assert_array_equal(k1, np.asarray(e1))
    np.testing.assert_array_equal(k2, np.asarray(e2))
    assert v.any() and not v.all()

    e1, e2, ev = jfused._window_queries_codes(
        jnp.asarray(codes), jnp.asarray(lengths), q1j, **kw
    )
    np.testing.assert_array_equal(v, np.asarray(ev))
    np.testing.assert_array_equal(k1[v], np.asarray(e1)[v])
    np.testing.assert_array_equal(k2[v], np.asarray(e2)[v])

    # The Pallas kernel takes only windows inside its code matrix.
    unpacked = _unpack(rp)
    q1p = tuple(q for q in q1s if q + width <= unpacked.shape[1])
    k1p, k2p, vp = window_queries.window_queries(
        _t(rp), _t(lengths), q1p, width=width, min_dinuc=min_dinuc
    )
    e1, e2, ev = pw.window_queries_pallas(
        jnp.asarray(unpacked), jnp.asarray(lengths), q1p, **kw
    )
    vp = vp.numpy()
    np.testing.assert_array_equal(vp, np.asarray(ev))
    np.testing.assert_array_equal(k1p.numpy().view(np.uint32)[vp], np.asarray(e1)[vp])
    np.testing.assert_array_equal(k2p.numpy().view(np.uint32)[vp], np.asarray(e2)[vp])


def test_window_table_matches_twin_slices():
    """The kernel's per-window (w0, sh, gate) table is the twin's clip,
    including windows past the packed width and packed widths narrower
    than a window's slice."""
    from muscato_tpu_torch.ops.window_queries import _window_table

    for nw in (1, 2, 3, 13):
        for width in (4, 8, 13, 20):
            nsl = -(-width // 8) + 1
            nwp = nw + max(1, nsl - nw)
            for q1 in (0, 3, 7, 8, 9, 30, 77, 90, 200):
                w0 = min(max(q1 >> 3, 0), nwp - nsl)
                sh = min(max((q1 - (w0 << 3)) * 4, 0), 31)
                assert _window_table(nw, (q1,), width) == [w0, sh, q1 + width]


@pytest.mark.parametrize("seed", range(6))
def test_monotone_gather_twin_matches_numpy(seed):
    rng = np.random.default_rng(200 + seed)
    n = int(rng.integers(1, 20000))
    table = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    idx = _monotone_idx(rng, n, int(rng.integers(1, 5000)))
    out, of = gather.monotone_gather(_t(table), _t(idx))
    assert of == 0
    np.testing.assert_array_equal(out.numpy(), pg.monotone_gather_np(table, idx))


def test_monotone_gather_twin_matches_pallas():
    rng = np.random.default_rng(3)
    n = 6000
    table = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    idx = np.sort(rng.integers(0, n, 2048)).astype(np.int32)  # two blocks
    out_p, of_p = pg.monotone_gather(
        jnp.asarray(table), jnp.asarray(idx), window=8192, interpret=True
    )
    out, _ = gather.monotone_gather(_t(table), _t(idx))
    assert int(of_p) == 0
    np.testing.assert_array_equal(out.numpy(), np.asarray(out_p))


@pytest.mark.parametrize("seed", range(3))
def test_monotone_gather_rows_twin_matches_numpy(seed):
    rng = np.random.default_rng(300 + seed)
    nrows, ncols = int(rng.integers(1, 3000)), 22
    table = rng.integers(0, 2**32, (nrows, ncols), dtype=np.uint64).astype(np.uint32)
    ridx = np.sort(rng.integers(0, nrows, int(rng.integers(1, 3000)))).astype(np.int32)
    out, of = gather.monotone_gather_rows(_t(table), _t(ridx))
    assert of == 0
    np.testing.assert_array_equal(out.numpy().view(np.uint32), table[ridx])


def test_monotone_gather_rows_twin_matches_pallas():
    rng = np.random.default_rng(5)
    nrows, ncols = 1500, 22  # the trows width at 100-base reads
    table = rng.integers(0, 2**32, (nrows, ncols), dtype=np.uint64).astype(np.uint32)
    ridx = np.sort(rng.integers(0, nrows, 1024)).astype(np.int32)  # one block
    out_p, of_p = pg.monotone_gather_rows(
        jnp.asarray(table), jnp.asarray(ridx), window_rows=2048, interpret=True
    )
    out, _ = gather.monotone_gather_rows(_t(table), _t(ridx))
    assert int(of_p) == 0
    np.testing.assert_array_equal(out.numpy().view(np.uint32), np.asarray(out_p))


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is not on the CPU never reaches a plain twin: the
    wrappers raise for devices they cannot launch on and for mixed
    devices, and launch counters stay put."""
    meta = torch.zeros(8, dtype=torch.int32, device="meta")
    cpu = torch.zeros(8, dtype=torch.int32)
    before = (join.sorted_join.launches, gather.monotone_gather.launches)
    with pytest.raises(ValueError):
        join.sorted_join(meta, meta)
    with pytest.raises(ValueError):
        gather.monotone_gather(cpu, meta)
    with pytest.raises(ValueError):
        gather.monotone_gather_rows(meta.reshape(2, 4), meta[:2])
    with pytest.raises(ValueError):
        expand.expand_owners(meta, meta, meta, pair_cap=8)
    with pytest.raises(ValueError):
        expand.expand_owners(meta, meta, meta, pair_cap=8, subchunk=True)
    with pytest.raises(ValueError):
        window_queries.window_queries(meta.reshape(4, 2), meta[:4], (0,),
                                      width=8, min_dinuc=0)
    assert (join.sorted_join.launches, gather.monotone_gather.launches) == before
    assert expand.expand_owners_sub.launches == 0
    assert window_queries.window_queries.launches == 0


def test_build_requires_nvcc(monkeypatch, tmp_path):
    """Without nvcc the build raises instead of degrading to a twin."""
    monkeypatch.setattr(_lib, "BUILD_ROOT", str(tmp_path))
    monkeypatch.setattr(_lib.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _lib._build()
    assert len(_lib.sources()) == 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_kernels_match_twins(cuda_device):
    rng = np.random.default_rng(42)
    keys, qs = _join_case(rng, 200_000, 150_000)
    lo, cnt, _ = join.sorted_join(_t(keys).to(cuda_device), _t(qs).to(cuda_device))
    lo_t, cnt_t, _ = join.sorted_join_torch(_t(keys), _t(qs))
    assert torch.equal(lo.cpu(), lo_t) and torch.equal(cnt.cpu(), cnt_t)

    oexcl, lo_s, qid, total = _slots_case(rng, 100_000)
    args = [_t(x) for x in (oexcl, lo_s, qid)]
    got = expand.expand_owners(*(a.to(cuda_device) for a in args), pair_cap=total + 777)
    exp = expand.expand_owners_torch(*args, pair_cap=total + 777)
    assert all(torch.equal(g.cpu(), e) for g, e in zip(got, exp))

    table = _t(rng.integers(-2**31, 2**31, 300_000, dtype=np.int64).astype(np.int32))
    idx = _t(_monotone_idx(rng, 300_000, 500_000))
    out, _ = gather.monotone_gather(table.to(cuda_device), idx.to(cuda_device))
    assert torch.equal(out.cpu(), gather.monotone_gather_torch(table, idx)[0])

    rows = _t(rng.integers(-2**31, 2**31, (50_000, 22), dtype=np.int64).astype(np.int32))
    ridx = _t(np.sort(rng.integers(0, 50_000, 200_000)).astype(np.int32))
    out, _ = gather.monotone_gather_rows(rows.to(cuda_device), ridx.to(cuda_device))
    assert torch.equal(out.cpu(), gather.monotone_gather_rows_torch(rows, ridx)[0])


@pytest.mark.gpu
def test_cuda_window_queries_and_sub_expand_match_twins(cuda_device):
    """B5 on short reads, X codes and windows past the packed width, for
    every width class, and B6 on the sub-chunk trials; exact against the
    twins."""
    rng = np.random.default_rng(43)
    codes, lengths = _wq_reads(rng, 20_000, 100)
    rp, ln = _t(jpacked.pack_rows_np(codes)), _t(lengths)
    for width in (4, 8, 13, 14, 20):
        for min_dinuc in (0, 3):
            kw = dict(width=width, min_dinuc=min_dinuc)
            got = window_queries.window_queries(
                rp.to(cuda_device), ln.to(cuda_device), WQ_WINDOWS, **kw)
            exp = window_queries.window_queries_torch(rp, ln, WQ_WINDOWS, **kw)
            assert all(torch.equal(g.cpu(), e) for g, e in zip(got, exp))
    for trial in range(5):
        oexcl, lo, qid, total, cap = _sub_trial(trial)
        args = [_t(x) for x in (oexcl, lo, qid)]
        got = expand.expand_owners(*(a.to(cuda_device) for a in args),
                                   pair_cap=cap, subchunk=True)
        exp = expand.expand_owners_torch(*args, pair_cap=cap)
        assert all(torch.equal(g.cpu(), e) for g, e in zip(got, exp))
