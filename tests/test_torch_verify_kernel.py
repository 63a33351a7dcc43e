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
is held against the twin on every lane (test_torch_verify_cuda.py holds
the kernel itself against the twin on the card).  chip_smoke.py's
sector-aware bound and bank-wavefront count for the kernel are held
against brute-force counts.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from muscato_tpu.ops import packed as jpacked
from muscato_tpu_torch.ops import packed as tpacked
from verify_cases import CASES, as_tensor as _t, lane_inputs as _inputs, swar_args


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


def test_sector_bound_counts_each_touched_sector_once():
    """chip_smoke's sector-aware bound of B7 (verify_sector_bytes) equals
    a count, sector by sector, of the 32-byte sectors that the lanes'
    arrays, their target words, their read rows, lengths and budget
    entries touch."""
    args, s = swar_args(5, 13, (20, 104), 0.02, (10, 30), n=700)
    r, d, t_rows, rp, lens, _, _, budget, _ = (x.numpy() if torch.is_tensor(x) else x
                                               for x in args)
    (c, tcols), (nreads, nw) = t_rows.shape, rp.shape
    touched = set()

    def touch(name, word0, nwords):
        touched.update((name, b >> 5) for b in range(4 * word0, 4 * (word0 + nwords)))

    for j in range(c):
        for name in ("r", "d", "gstart", "gend", "nx", "s", "okbits"):
            touch(name, j, 1)
        rc, dc = min(max(int(r[j]), 0), nreads - 1), min(max(int(d[j]), 0), s - 1)
        touch("t_rows", j * tcols + ((dc >> 3) & 7), nw + 1)
        touch("rpacked", rc * nw, nw)
        touch("lengths", rc, 1)
        touch("budget", min(max(int(lens[rc]), 0), len(budget) - 1), 1)
    assert _chip_smoke().verify_sector_bytes(args, s) == 32 * len(touched)


def test_bank_wavefronts_count_the_busiest_bank():
    """chip_smoke's count of the staged kernel's target-row bank
    wavefronts (verify_bank_wavefronts) equals, warp load by warp load,
    the most distinct shared-memory words that fall in one bank, with the
    rows staged in 128-lane tiles behind the 16-byte barrier (the count
    holds for any tile of whole warps: the base moves a warp's words
    together)."""
    args, s = swar_args(6, 13, (20, 104), 0.02, (10, 30), n=1024)
    d, t_rows, nw = args[1].numpy(), args[2], args[3].shape[1]
    tcols, loads = t_rows.shape[1], []
    for w0 in range(0, t_rows.shape[0], 32):
        for w in range(nw + 1):
            words = {4 + (j % 128) * tcols + ((min(max(int(d[j]), 0), s - 1) >> 3) & 7) + w
                     for j in range(w0, w0 + 32)}
            loads.append(max(sum(1 for x in words if x % 32 == b) for b in range(32)))
    assert _chip_smoke().verify_bank_wavefronts(args, s) == pytest.approx(np.mean(loads))
