"""The dedup verify's SWAR body (B7: ``csrc/verify.cu``, wrapper
``muscato_tpu_torch.ops.packed.verify_diagonals_swar``, plain twin
``verify_diagonals_swar_torch``).

On the CPU the port's ``verify_diagonals_packed`` runs the twin; it is
held against ``muscato_tpu.ops.packed.verify_diagonals_packed`` in
diagonal order (``dorder=True``), once with the Pallas gathers in
interpret mode (``mgather=True``) and once with XLA's gathers, on the
same seeded inputs.  Exact: okbits on every lane, nx, gene and start on
active lanes (the JAX function leaves them unspecified elsewhere).  A
numpy model of the kernel's per-lane loop (words streamed through a
funnel shift, windows tested only while the lane is within its budget)
is held against the twin on every lane, and the card test holds the
kernel itself against the twin (marked ``gpu``: it skips without a card).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from muscato_tpu.ops import packed as jpacked
from muscato_tpu.ops import verify as jverify
from muscato_tpu_torch.ops import packed as tpacked

# (width, window offsets, read words, read lengths, X rate)
CASES = {
    "w8-1win-4words": (8, (0,), 4, (20, 32), 0.01),
    "w20-4win-13words": (20, (10, 30, 50, 70), 13, (20, 104), 0.02),
    "w40-4win-19words": (40, (0, 40, 80, 110), 19, (20, 150), 0.05),
    "w8-31win-10words": (8, tuple(range(0, 62, 2)), 10, (40, 80), 0.03),
    "w20-past-width-13words": (20, (0, 20, 100, 130), 13, (90, 104), 0.01),
    "w40-1win-18words": (40, (0,), 18, (20, 144), 0.04),
}


def _t(a) -> torch.Tensor:
    a = np.array(a)  # a writable copy (jax arrays are read-only)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _inputs(seed, nwords, lengths, x_rate, n=768, nreads=200, s=6000):
    """Lanes sorted by diagonal as the engine feeds a verify chunk:
    negative diagonals in front, a dead tail (r = -1, d = 0, the chunk's
    padding), lanes at gene starts (the pos-0 quirk) and at the last
    stream position, and a quarter of the live lanes planted (the target
    under the diagonal with 0-3 substitutions), over irregular genes with
    X codes in reads and targets."""
    rng = np.random.default_rng(seed)
    max_rl = 8 * nwords
    cuts = np.sort(rng.choice(np.arange(1, s), 12, replace=False))
    gene_start = np.concatenate([[0], cuts, [s]]).astype(np.int32)
    tcat = rng.integers(0, 4, s).astype(np.uint8)
    tcat[rng.random(s) < x_rate] = 4
    codes = rng.integers(0, 4, (nreads, max_rl)).astype(np.uint8)
    codes[rng.random(codes.shape) < x_rate] = 4
    lens = rng.integers(lengths[0], lengths[1] + 1, nreads).astype(np.int32)
    ndead = n // 12
    d = rng.integers(0, s, n - ndead)
    d[:40] = rng.choice(gene_start[:-1], 40)
    d[40:44] = s - 1
    d = np.sort(d).astype(np.int32)
    d[:5] = [-9, -4, -4, -1, 0]
    r = rng.integers(0, nreads, n - ndead).astype(np.int32)
    live = np.flatnonzero(d >= 0)
    planted = rng.choice(live, nreads // 2, replace=False)
    r[planted] = rng.permutation(nreads)[: len(planted)]
    for i in planted:
        seg = tcat[d[i]: d[i] + max_rl].copy()
        at = rng.integers(0, len(seg), rng.integers(0, 4))
        seg[at] = (seg[at] + 1) % 5
        codes[r[i], : len(seg)] = seg
    codes[np.arange(max_rl)[None, :] >= lens[:, None]] = 0
    r = np.concatenate([r, np.full(ndead, -1, np.int32)])
    d = np.concatenate([d, np.zeros(ndead, np.int32)])
    budget = jverify.mismatch_budget_table(0.9, max_rl)
    return r, d, codes, lens, tcat, gene_start, budget, s


@pytest.mark.parametrize("mgather", [True, False], ids=["pallas-interpret", "xla"])
@pytest.mark.parametrize("case", list(CASES))
def test_verify_diagonals_matches_jax(case, mgather):
    width, q1s, nwords, lengths, x_rate = CASES[case]
    seed = list(CASES).index(case)
    r, d, codes, lens, tcat, gene_start, budget, s = _inputs(seed, nwords, lengths, x_rate)
    max_rl = 8 * nwords
    rp = jpacked.pack_rows_np(codes)
    tp = jpacked.pack_stream(tcat)
    trows = jpacked.build_trows(tp, nwords, s)
    gb, steps = jpacked.build_gene_block(gene_start, s)

    exp = jpacked.verify_diagonals_packed(
        jnp.asarray(r), jnp.asarray(d), jnp.asarray(rp), jnp.asarray(lens), tp,
        jnp.asarray(gene_start), jnp.asarray(budget), jnp.asarray(np.array(q1s, np.int32)),
        width, max_rl, s, trows=trows, gblock=jnp.asarray(gb), gsteps=steps, dorder=True,
        mgather=mgather, interpret=mgather,
    )
    before = tpacked.verify_diagonals_swar.launches
    got = tpacked.verify_diagonals_packed(
        _t(r), _t(d), _t(rp), _t(lens), _t(gene_start), _t(budget), q1s, width, s,
        _t(np.asarray(trows)), _t(gb), steps,
    )
    assert tpacked.verify_diagonals_swar.launches == before
    assert int(exp[4]) == 0, "a Pallas gather window overflowed"
    okbits = np.asarray(exp[3])
    assert (okbits != 0).sum() > 20
    np.testing.assert_array_equal(got[3].numpy(), okbits)
    act = (r >= 0) & (d >= 0)
    for name, a, b in zip(("nx", "g", "s"), got[:3], exp[:3]):
        np.testing.assert_array_equal(a.numpy()[act], np.asarray(b)[act], err_msg=name)


def _nib_mask(k: int) -> int:
    k = min(max(k, 0), 8)
    return (1 << (4 * k)) - 1


def _kernel_model(r, d, t_rows, rpacked, lengths, gstart, gend, budget, q1s, width, smax):
    """csrc/verify.cu's per-lane loop in numpy integers: the aligned word
    is (next:prev) >> rshift with the previous target word carried, and a
    word's mismatches mark the windows they fall in only while the running
    nx is within the budget."""
    nreads, nwords = rpacked.shape
    t_rows, rpacked = t_rows.view(np.uint32), rpacked.view(np.uint32)
    out = np.zeros((3, len(r)), np.int64)
    for j in range(len(r)):
        rc, dc = min(max(int(r[j]), 0), nreads - 1), min(max(int(d[j]), 0), smax - 1)
        gs, ge = int(gstart[j]), int(gend[j])
        s, rlen = dc - gs, int(lengths[rc])
        bud = int(budget[min(max(rlen, 0), len(budget) - 1)])
        t = t_rows[j, (dc >> 3) & 7:]
        prev, nx, bad = int(t[0]), 0, 0
        for w in range(nwords):
            nxt = int(t[w + 1])
            x = ((((nxt << 32) | prev) >> ((dc & 7) * 4)) & 0xFFFFFFFF) ^ int(rpacked[rc, w])
            prev = nxt
            x &= _nib_mask(rlen - 8 * w)
            nz = (x | x >> 1 | x >> 2 | x >> 3) & 0x11111111
            nx += bin(nz).count("1")
            if nz and nx <= bud:
                for k, q in enumerate(q1s):
                    if nz & _nib_mask(q - 8 * w + width) & ~_nib_mask(q - 8 * w):
                        bad |= 1 << k
        ok = 0
        if r[j] >= 0 and d[j] >= 0 and nx <= bud:
            glen = ge - gs
            for k, q in enumerate(q1s):
                fit = (rlen <= min(glen, 100 - width)) if q == 0 and s == 0 else (
                    rlen + s <= glen)
                if dc + q < ge and fit and not (bad >> k) & 1:
                    ok |= 1 << k
        out[:, j] = nx, s, np.uint32(ok).view(np.int32)
    return out


def test_swar_wrapper_on_cpu_is_the_twin():
    """On CPU tensors the wrapper returns its twin's outputs on every lane,
    dead lanes included, and launches nothing; the twin equals the
    kernel's per-lane loop (numpy model) on every lane; a tensor off the
    CPU never reaches the twin."""
    width, q1s = 20, (0, 10, 30, 50, 70, 90)
    r, d, codes, lens, tcat, gene_start, budget, s = _inputs(11, 13, (20, 104), 0.03, n=600)
    rp = tpacked.pack_rows(torch.from_numpy(codes))
    trows = tpacked.build_trows(_t(tpacked.pack_stream(tcat)), 13, s)
    gb, steps = tpacked.build_gene_block(gene_start, s)
    rt, dt = _t(r), _t(d)
    _, gstart, gend, t_rows = tpacked.diagonal_fetch(rt, dt, _t(gene_start), _t(gb), steps,
                                                     trows, s)
    args = (rt, dt, t_rows, rp, _t(lens), gstart, gend, _t(budget), q1s)
    before = tpacked.verify_diagonals_swar.launches
    got = tpacked.verify_diagonals_swar(*args, width=width, smax=s)
    twin = tpacked.verify_diagonals_swar_torch(*args, width=width, smax=s)
    assert tpacked.verify_diagonals_swar.launches == before
    for a, b in zip(got, twin):
        assert a.dtype == torch.int32 and torch.equal(a, b)
    assert (twin[2] != 0).sum() > 20
    model = _kernel_model(*(x.numpy() for x in args[:8]), q1s, width, s)
    for name, a, b in zip(("nx", "s", "okbits"), twin, model):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    meta = [x.to("meta") if x is rp else x for x in args]
    with pytest.raises(ValueError):
        tpacked.verify_diagonals_swar(*meta, width=width, smax=s)
    assert tpacked.verify_diagonals_swar.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_verify_kernel_matches_twin(cuda_device):
    """B7 on the card, exact against its twin on every lane, for every
    case above."""
    for seed, (width, q1s, nwords, lengths, x_rate) in enumerate(CASES.values()):
        r, d, codes, lens, tcat, gene_start, budget, s = _inputs(seed, nwords, lengths, x_rate)
        rp = tpacked.pack_rows(torch.from_numpy(codes))
        trows = tpacked.build_trows(_t(tpacked.pack_stream(tcat)), nwords, s)
        gb, steps = tpacked.build_gene_block(gene_start, s)
        _, gstart, gend, t_rows = tpacked.diagonal_fetch(
            _t(r), _t(d), _t(gene_start), _t(gb), steps, trows, s)
        args = (_t(r), _t(d), t_rows, rp, _t(lens), gstart, gend, _t(budget), q1s)
        before = tpacked.verify_diagonals_swar.launches
        got = tpacked.verify_diagonals_swar(*(x.to(cuda_device) if torch.is_tensor(x) else x
                                              for x in args), width=width, smax=s)
        assert tpacked.verify_diagonals_swar.launches == before + 1
        for a, b in zip(got, tpacked.verify_diagonals_swar_torch(*args, width=width, smax=s)):
            assert torch.equal(a.cpu(), b)
