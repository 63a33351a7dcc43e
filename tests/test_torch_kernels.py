"""The port's kernels (muscato_tpu_torch/ops/{join,expand,gather,
window_queries}.py) against the JAX package's numpy oracles, XLA functions
and Pallas kernels.

On the CPU each wrapper runs its plain PyTorch twin; the Pallas functions
run in interpret mode at one or two blocks (interpret mode is slow).  The
CUDA kernels themselves are checked against the twins by the tests marked
``gpu``, which skip without a card.  All outputs are integers and must be
exactly equal.
"""

import contextlib
import os
import types

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
    assert [os.path.basename(p) for p in _lib.sources()] == [
        "expand.cu", "gather.cu", "join.cu", "probe.cu", "verify.cu", "windows.cu"]


def test_build_digest_covers_headers(monkeypatch, tmp_path):
    """The build is keyed on the headers the sources include too, so an
    edited header never loads a library built from the old one."""
    monkeypatch.setattr(_lib, "CSRC", str(tmp_path))
    (tmp_path / "a.cu").write_text('#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// one\n")
    before = _lib._digest(_lib.sources())
    (tmp_path / "b.cuh").write_text("// two\n")
    assert _lib.sources() == [str(tmp_path / "a.cu")]
    assert _lib._digest(_lib.sources()) != before


def test_build_digest_covers_flags():
    """A build with other flags (chip_smoke's unstaged variant) lands in
    its own directory, never in the default build's."""
    srcs = _lib.sources()
    assert _lib._digest(srcs, _lib.NVCC_FLAGS + ("-DMUSCATO_NO_STAGE",)) != _lib._digest(srcs)


class _FakeLib:
    """Stands in for a kernel library: one launcher that records its calls
    and returns ``rc``."""

    def __init__(self, rc):
        self.calls, self.lookups, self.rc = [], 0, rc

    def __getattr__(self, name):
        if name != "muscato_fake":
            raise AttributeError(name)
        self.lookups += 1
        return lambda *args: self.calls.append(args) or self.rc


def _fake_cuda(monkeypatch, current):
    """torch.cuda as launch sees it with device ``current`` current; a
    device switch raises."""
    stream = type("Stream", (), {"cuda_stream": 1234})()
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: stream)

    def no_switch(dev):
        raise AssertionError(f"switched to {dev}")
    monkeypatch.setattr(torch.cuda, "device", no_switch)


def test_launch_looks_up_once_and_passes_the_stream(monkeypatch):
    """On the current device launch passes the current stream last, looks
    the launcher up once per library, and never switches the device."""
    _fake_cuda(monkeypatch, 0)
    lib = _FakeLib(0)
    like = types.SimpleNamespace(device=torch.device("cuda", 0))
    for _ in range(3):
        _lib.launch("fake", like, 7, 8, lib=lib)
    assert lib.calls == [(7, 8, 1234)] * 3
    assert lib.lookups == 1


@pytest.mark.parametrize("current", [0, 1])
def test_launch_raises_on_a_refused_launch(monkeypatch, current):
    """A nonzero cudaError raises, on the current device and on another
    one, which launch enters first."""
    _fake_cuda(monkeypatch, current)
    entered = []

    @contextlib.contextmanager
    def enter(dev):
        entered.append(dev)
        yield

    monkeypatch.setattr(torch.cuda, "device", enter)
    like = types.SimpleNamespace(device=torch.device("cuda", 1))
    with pytest.raises(RuntimeError, match="cudaError 9"):
        _lib.launch("fake", like, lib=_FakeLib(9))
    assert entered == ([] if current == 1 else [torch.device("cuda", 1)])


# B1's staged span and tile (csrc/join.cu kJoinSpan, kJoinTile) and B4's
# tile (csrc/gather.cu kRowTile).
JOIN_SPAN, JOIN_TILE, ROW_TILE = 6144, 512, 256


def _join_branch_cases(rng):
    """(label, keys, queries, offset) reaching each branch of B1: the
    index sliced at ``offset`` on the device (1: not 16-byte aligned, so
    staged by plain loads); an equal-key run longer than the staged span
    that queries hit (the global-memory branch); unsorted queries; a
    ragged last tile that queries the top key of an index whose length is
    not a multiple of 4 (the staged tail past the last whole 16 bytes)."""
    run = np.uint32(rng.integers(1, 2**32 - 1))
    keys = np.sort(np.concatenate([
        rng.integers(0, 2**32, 50_003, dtype=np.uint64).astype(np.uint32),
        np.full(JOIN_SPAN + 7_000, run, np.uint32),
    ]))
    assert len(keys) % 4 == 3
    qs = np.concatenate([
        rng.choice(keys, 30_001), np.full(5_000, run, np.uint32),
        rng.integers(0, 2**32, 10_000, dtype=np.uint64).astype(np.uint32), keys[-1:],
    ])
    assert len(qs) % JOIN_TILE
    return [("long run, ragged tile", keys, np.sort(qs), 0),
            ("unsorted queries", keys, rng.permutation(qs), 0),
            ("unaligned index", keys, np.sort(qs), 1)]


def _rows_branch_cases(rng):
    """(label, table, ridx, offset) reaching each branch of B4: dense
    sorted tiles over a quarter of the table; 64-row runs fetched twice
    (step-backs inside a tile); scattered rows (sparse tiles); the last
    row of a table whose word count is not a multiple of 4 (the staged
    tail); a table sliced at ``offset`` rows on the device (88 bytes: 8-
    but not 16-byte aligned, so the 8-byte pieces are staged by plain
    loads); 16-word rows (8-byte pieces at another even width); 5-word
    rows, whole and sliced to 4-byte alignment, dense and scattered (the
    4-byte word path); every case has a ragged last tile."""
    nrows = 20_001
    table = rng.integers(0, 2**32, (nrows, 22), dtype=np.uint64).astype(np.uint32)
    dense = np.sort(rng.integers(5_000, 10_000, 64 * 999)).astype(np.int32)
    last = np.sort(np.append(rng.integers(15_000, nrows, 9_000), nrows - 1)).astype(np.int32)
    assert (nrows * 22) % 4 == 2
    cases = [
        ("dense", table, dense, 0),
        ("step-backs", table, np.repeat(dense.reshape(-1, 64), 2, axis=0).reshape(-1), 0),
        ("scattered", table, rng.integers(0, nrows, 30_001).astype(np.int32), 0),
        ("last row, odd word count", table, last, 0),
        ("unaligned table", table, dense, 1),
        ("16-word rows", np.ascontiguousarray(table[:, :16]), dense, 0),
        ("5-word rows, scattered", np.ascontiguousarray(table[:, :5]),
         rng.integers(0, nrows, 30_001).astype(np.int32), 0),
        ("5-word rows", np.ascontiguousarray(table[:, :5]), dense, 0),
        ("5-word rows, unaligned table", np.ascontiguousarray(table[:, :5]), dense, 1),
    ]
    assert all(len(r) % ROW_TILE for _, _, r, _ in cases)
    return cases


def test_branch_cases_twins_match_numpy():
    """The branch cases the GPU test runs: their twins against the JAX
    package's numpy oracle and plain numpy indexing."""
    rng = np.random.default_rng(44)
    for label, keys, qs, off in _join_branch_cases(rng):
        lo, cnt, _ = join.sorted_join(_t(keys)[off:], _t(qs))
        lo_np, cnt_np = pj.sorted_join_np(keys[off:], qs)
        np.testing.assert_array_equal(lo.numpy(), lo_np, err_msg=label)
        np.testing.assert_array_equal(cnt.numpy(), cnt_np, err_msg=label)
    for label, table, ridx, off in _rows_branch_cases(rng):
        ridx = np.minimum(ridx, len(table) - 1 - off)
        out, _ = gather.monotone_gather_rows(_t(table)[off:], _t(ridx))
        np.testing.assert_array_equal(out.numpy().view(np.uint32), table[off:][ridx],
                                      err_msg=label)


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


@pytest.mark.gpu
def test_cuda_join_and_row_gather_branches(cuda_device):
    """Every branch of B1 and B4 exact against the twins: the bulk-copied
    and the plainly loaded stage, the staged tail, the global-memory
    fallback, step-backs, ragged tiles and the runtime-width row kernel.
    Slices are taken on the device, so their base pointers are not 16-byte
    aligned."""
    rng = np.random.default_rng(44)
    for label, keys, qs, off in _join_branch_cases(rng):
        k, q = _t(keys), _t(qs)
        got = join.sorted_join(k.to(cuda_device)[off:], q.to(cuda_device))
        exp = join.sorted_join_torch(k[off:], q)
        assert all(torch.equal(g.cpu(), e) for g, e in zip(got[:2], exp[:2])), label
    for label, table, ridx, off in _rows_branch_cases(rng):
        t, r = _t(table), _t(np.minimum(ridx, len(table) - 1 - off))
        out, _ = gather.monotone_gather_rows(t.to(cuda_device)[off:], r.to(cuda_device))
        assert torch.equal(out.cpu(), gather.monotone_gather_rows_torch(t[off:], r)[0]), label


# B2's tile and stage, a warp's, and the lanes of two of its CTAs (eight
# warps at four tiles each; csrc/expand.cu kExpTile, kExpStage, kExpWarps,
# kExpTiles), and B5's tile (csrc/windows.cu kThreads).
EXP_TILE, EXP_STAGE, EXP_CTA, WQ_TILE = 128, 384, 8192, 256
# B6's ring of slots and the fewest lanes a warp takes (csrc/expand.cu
# kSubRing x kSubSlots, kSubMinTiles x kExpTile): below 2048 x the card's
# resident warps, every warp range is SUB_CHUNK lanes.
SUB_RING, SUB_CHUNK = 512, 2048


def _slots_of(rng, counts):
    """(oexcl, lo, qid, total) of slots with the given lane counts."""
    counts = np.asarray(counts, np.int32)
    m = len(counts)
    oexcl = (np.cumsum(counts) - counts).astype(np.int32)
    lo = rng.integers(0, 1 << 20, m).astype(np.int32)
    qid = rng.integers(0, 1 << 24, m).astype(np.int32)
    return oexcl, lo, qid, int(counts.sum())


def _expand_case(label):
    """(oexcl, lo, qid, pair_cap, offset) reaching one branch of B2 or B6; the
    three slot arrays are sliced at ``offset`` on the device (1 or 2: not
    16-byte aligned, so staged by 4-byte loads; the lanes before the
    first remaining offset then clip to slot 0)."""
    rng = np.random.default_rng(sorted(EXPAND_CASES).index(label))
    live = lambda n: rng.integers(1, 5, n)
    off = 0
    if label == "dead tail, several tiles past the total":
        oexcl, lo, qid, total = _slots_of(rng, np.concatenate([live(3000), np.zeros(2000)]))
        cap = total + 3 * EXP_CTA + 5 * EXP_TILE + 13
    elif label == "empty run longer than the stage inside a tile":
        oexcl, lo, qid, total = _slots_of(
            rng, np.concatenate([live(5000), np.zeros(EXP_STAGE + 2500), live(5000)]))
        cap = total + 3
    elif label == "one slot owns several CTAs' lanes":
        oexcl, lo, qid, total = _slots_of(
            rng, np.concatenate([live(500), [EXP_CTA + 5 * EXP_TILE + 7], live(5000)]))
        cap = total
    elif label == "one slot":
        oexcl, lo, qid, total = _slots_of(rng, [0])
        cap = EXP_CTA + 2 * EXP_TILE + 53
    elif label == "one slot, offset past the first lanes":
        oexcl, lo, qid, total = _slots_of(rng, [7, 3])
        cap, off = EXP_CTA + EXP_TILE + 5, 1
    elif label == "one lane a slot, then the dead tail":
        oexcl, lo, qid, total = _slots_of(rng, np.concatenate([np.ones(20_000), np.zeros(3000)]))
        cap = total + EXP_CTA + EXP_TILE + 2
    elif label == "interior empty slots":
        oexcl, lo, qid, total = _slots_of(rng, rng.integers(0, 3, 20_000))
        cap = total + 1
    elif label == "mostly empty slots":
        oexcl, lo, qid, total = _slots_of(rng, rng.integers(0, 4, 40_000) // 3)
        cap = total + 2
    elif label == "fewer lanes than a tile":
        oexcl, lo, qid, total = _slots_of(rng, live(40))
        cap = total - 1
    elif label == "a ring that wraps several times":
        oexcl, lo, qid, total = _slots_of(rng, rng.integers(1, 3, 5 * SUB_CHUNK))
        cap = total + 77
    elif label == "an empty run longer than the ring inside a warp range":
        oexcl, lo, qid, total = _slots_of(
            rng, np.concatenate([live(3000), np.zeros(3 * SUB_RING + 17), live(3000)]))
        cap = total + 5
    elif label == "warp ranges that start inside empty runs":
        # A run at lane 2 SUB_CHUNK + 3 (the range's first owner lies before
        # it) and one at lane 3 SUB_CHUNK (the search lands past it).
        oexcl, lo, qid, total = _slots_of(rng, np.concatenate([
            np.ones(2 * SUB_CHUNK + 3), np.zeros(2 * SUB_RING), np.ones(SUB_CHUNK - 3),
            np.zeros(SUB_RING + 50), live(2000)]))
        cap = total + 9
    elif label == "one slot owns several warp ranges":
        oexcl, lo, qid, total = _slots_of(
            rng, np.concatenate([live(500), [3 * SUB_CHUNK + 77], live(2000)]))
        cap = total
    elif label == "a dead tail that starts inside a warp range":
        counts = live(4000)
        counts[-1] += (1000 - counts.sum()) % SUB_CHUNK
        oexcl, lo, qid, total = _slots_of(rng, np.concatenate([counts, np.zeros(3000)]))
        assert total % SUB_CHUNK == 1000
        cap = total + 2 * SUB_CHUNK + 300
    elif label == "fewer lanes than a warp range":
        oexcl, lo, qid, total = _slots_of(rng, live(300))
        cap = total + 100
    elif label.startswith("slots sliced"):
        oexcl, lo, qid, total = _slots_of(rng, np.concatenate([live(6000), np.zeros(900)]))
        cap, off = total + EXP_CTA + 2 * EXP_TILE + 1, int(label[-1])
    else:
        raise KeyError(label)
    return oexcl, lo, qid, cap + (cap % 4 == 0), off  # never whole 16-byte stores


EXPAND_CASES = (
    "dead tail, several tiles past the total",
    "empty run longer than the stage inside a tile",
    "one slot owns several CTAs' lanes",
    "one slot",
    "one slot, offset past the first lanes",
    "one lane a slot, then the dead tail",
    "interior empty slots",
    "mostly empty slots",
    "fewer lanes than a tile",
    "slots sliced by 1",
    "slots sliced by 2",
    "a ring that wraps several times",
    "an empty run longer than the ring inside a warp range",
    "warp ranges that start inside empty runs",
    "one slot owns several warp ranges",
    "a dead tail that starts inside a warp range",
    "fewer lanes than a warp range",
)


def _windows_case(label):
    """(rpacked, lengths, q1s, width, min_dinuc, offset) reaching one
    branch of B5; rpacked and lengths are sliced by ``offset`` rows on the
    device.  Half the rows hold codes 0-4, half random words, whose
    nibbles exceed the code range (dinucleotide indices past bit 31); the
    read count is not a multiple of the tile."""
    rng = np.random.default_rng(100 + sorted(WINDOWS_CASES).index(label))
    nw, q1s, width, md, off = 13, None, 20, 3, 0
    if label.startswith("width"):
        _, w, _, d = label.split()
        width, md = int(w.rstrip(",")), int(d)
    elif label.startswith("even row width"):
        nw = 14
    elif label == "one window":
        q1s = (37,)
    elif label == "64 windows":
        q1s, width = tuple(range(0, 128, 2)), 8
    elif label == "rows narrower than a window's slice":
        nw, q1s, width = 2, (0, 3, 9), 13
    elif label.endswith("rows (fewer reads a tile than threads)"):
        nw = int(label.split("-")[0])
    elif label == "sliced by one row":
        off = 1
    elif label == "sliced by one row, even row width":
        nw, off = 14, 1
    else:
        raise KeyError(label)
    if q1s is None:  # the last window runs past the packed width
        q1s = WQ_WINDOWS + (nw * 8 - 3,)
    nreads = 3 * WQ_TILE + 9
    codes, lengths = _wq_reads(rng, nreads, nw * 8)
    rp = jpacked.pack_rows_np(codes)
    assert rp.shape == (nreads, nw)
    assert len(q1s) == 1 or any(q + width > nw * 8 for q in q1s)
    rp[nreads // 2:] = rng.integers(0, 2**32, (nreads - nreads // 2, nw),
                                    dtype=np.uint64).astype(np.uint32)
    return rp, lengths, q1s, width, md, off


WINDOWS_CASES = tuple(
    [f"width {w}, min_dinuc {d}" for w in (4, 8, 13, 14, 20) for d in (0, 3)]
    + ["even row width", "one window", "64 windows",
       "rows narrower than a window's slice",
       "50-word rows (fewer reads a tile than threads)",
       "51-word rows (fewer reads a tile than threads)", "sliced by one row",
       "sliced by one row, even row width"]
)


@pytest.mark.parametrize("label", EXPAND_CASES)
def test_expand_branch_case_twin_matches_numpy(label):
    """B2's and B6's branch cases, which the GPU test runs on the card: the
    twin against the JAX package's numpy oracle on every lane."""
    oexcl, lo, qid, cap, off = _expand_case(label)
    q, s = expand.expand_owners(_t(oexcl)[off:], _t(lo)[off:], _t(qid)[off:], pair_cap=cap)
    q_np, s_np = pe.expand_owners_np(oexcl[off:], lo[off:], qid[off:], cap)
    assert cap % 4 and cap % EXP_TILE
    np.testing.assert_array_equal(q.numpy(), q_np)
    np.testing.assert_array_equal(s.numpy(), s_np)


@pytest.mark.parametrize("label", WINDOWS_CASES)
def test_windows_branch_case_twin_matches_jax(label):
    """B5's branch cases, which the GPU test runs on the card: the twin
    against the JAX package's packed XLA function on every lane."""
    rp, lengths, q1s, width, md, off = _windows_case(label)
    rp, lengths = rp[off:], lengths[off:]
    k1, k2, v = window_queries.window_queries(
        _t(rp), _t(lengths), q1s, width=width, min_dinuc=md)
    e1, e2, ev = jfused._window_queries(
        jnp.asarray(rp), jnp.asarray(lengths), jnp.asarray(np.array(q1s, np.int32)),
        width=width, min_dinuc=md)
    assert len(rp) % WQ_TILE and v.any() and not v.all()
    np.testing.assert_array_equal(v.numpy(), np.asarray(ev))
    np.testing.assert_array_equal(k1.numpy().view(np.uint32), np.asarray(e1))
    np.testing.assert_array_equal(k2.numpy().view(np.uint32), np.asarray(e2))


@pytest.mark.gpu
def test_cuda_expand_and_windows_branches(cuda_device):
    """Every branch of B2, B6 and B5 exact against the twins: whole-tile
    fills (dead tail, one slot), head flags and the scan, the second
    staging round, the global-memory search past the stage or the ring,
    the ring's wraps and restarts, warp ranges that start inside empty
    runs or the dead tail, 4-byte-aligned slot views and ragged buffers;
    bulk-copied and loop-copied rows, every
    width class with and without the dinucleotide gate, 1 and 64 windows,
    windows past the packed width and nibbles past the code range.  Slices
    are taken on the device."""
    for label in EXPAND_CASES:
        oexcl, lo, qid, cap, off = _expand_case(label)
        args = [_t(x) for x in (oexcl, lo, qid)]
        for sub in (False, True):
            got = expand.expand_owners(*(a.to(cuda_device)[off:] for a in args),
                                       pair_cap=cap, subchunk=sub)
            exp = expand.expand_owners_torch(*(a[off:] for a in args), pair_cap=cap)
            assert all(torch.equal(g.cpu(), e) for g, e in zip(got, exp)), (label, sub)
    for label in WINDOWS_CASES:
        rp, lengths, q1s, width, md, off = _windows_case(label)
        rp, ln = _t(rp), _t(lengths)
        kw = dict(width=width, min_dinuc=md)
        got = window_queries.window_queries(
            rp.to(cuda_device)[off:], ln.to(cuda_device)[off:], q1s, **kw)
        exp = window_queries.window_queries_torch(rp[off:], ln[off:], q1s, **kw)
        assert all(torch.equal(g.cpu(), e) for g, e in zip(got, exp)), label
