"""The port's plain references (muscato_tpu_torch/ops/verify.py
``verify_pairs_dynq``, ops/packed.py ``gene_of_pos`` and ``unpack_rows``)
against the JAX package's on seeded numpy inputs, including the
position-0 quirk and inactive lanes; then the port's two SWAR verifies
(``verify_pairs_packed``, ``verify_diagonals_packed``) fuzzed against the
port's ``verify_pairs_dynq``, as tests/test_kernels.py holds the JAX
package's SWAR verify to its byte verify."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from muscato_tpu.ops import packed as jpacked
from muscato_tpu.ops import verify as jverify
from muscato_tpu_torch.ops import packed as tpacked
from muscato_tpu_torch.ops import verify as tverify


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the suite runs several workers on the
    host's cores, where small tensor ops on many threads wait on each
    other (micro_verify's CPU run slowed over a hundredfold on 8 threads
    beside 8 busy processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed, q1, width=7, max_rl=64, n_pairs=512, s=4000, gene_start=None):
    """Target stream, reads (a third of the pairs made true matches at
    their diagonal), lanes (every 17th inactive, every 23rd at a gene's
    position 0), as numpy arrays."""
    rng = np.random.default_rng(seed)
    tcat = rng.integers(0, 5, s).astype(np.uint8)
    if gene_start is None:
        gene_start = np.array([0, 1500, 2250, 2290, s], dtype=np.int32)
    codes = rng.integers(0, 5, (100, max_rl)).astype(np.uint8)
    lengths = rng.integers(width + q1, max_rl + 1, 100).astype(np.int32)
    for i in range(100):
        codes[i, lengths[i]:] = 0
    r = rng.integers(0, 100, n_pairs).astype(np.int32)
    p = rng.integers(0, s - width, n_pairs).astype(np.int32)
    p[::23] = rng.choice(gene_start[:-1], len(p[::23])) + q1  # the pos-0 sites
    for i in range(0, n_pairs, 3):
        d = p[i] - q1
        if d >= 0 and d + lengths[r[i]] <= s:
            codes[r[i], : lengths[r[i]]] = tcat[d : d + lengths[r[i]]]
    r[::17] = -1
    p[5::29] = -1
    return tcat, gene_start, codes, lengths, r, p


@pytest.mark.parametrize("q1,max_rl,q1_tensor", [
    (0, 64, False), (0, 150, False), (3, 64, True), (9, 200, False)])
def test_verify_pairs_dynq_matches_jax(q1, max_rl, q1_tensor):
    """Reads up to 150 and 200 bases hit the position-0 cap of 100 - q2."""
    width = 7
    tcat, gs, codes, lengths, r, p = _case(q1 + max_rl, q1, width, max_rl)
    budget = jverify.mismatch_budget_table(0.9, max_rl)
    exp = jverify.verify_pairs_dynq(
        jnp.asarray(r), jnp.asarray(p), jnp.asarray(codes), jnp.asarray(lengths),
        jnp.asarray(tcat), jnp.asarray(gs), jnp.asarray(budget), q1, width, max_rl)
    got = tverify.verify_pairs_dynq(
        torch.from_numpy(r), torch.from_numpy(p), torch.from_numpy(codes),
        torch.from_numpy(lengths), torch.from_numpy(tcat), torch.from_numpy(gs),
        torch.from_numpy(budget), torch.tensor(q1) if q1_tensor else q1, width, max_rl)
    for name, a, b in zip(("keep", "nx", "g", "s"), exp, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    keep = got[0].numpy()
    assert keep.sum() > 20 and not keep[r < 0].any() and not keep[p < 0].any()


def test_pos0_quirk_in_the_reference():
    """A read of 120 bases equal to the gene at position 0: window offset
    0 hits position 0 and is dropped by the 100 - q2 cap; the same read
    one base into another gene is kept."""
    width, max_rl = 8, 200
    read = np.array([(i * 7 + 3) % 4 for i in range(120)], np.uint8)
    tail = np.tile(np.arange(4, dtype=np.uint8), 10)
    tcat = np.concatenate([read, tail, [1], read, tail])
    gs = np.array([0, 160, len(tcat)], np.int32)
    codes = read[None, :]
    out = tverify.verify_pairs_dynq(
        torch.tensor([0, 0], dtype=torch.int32), torch.tensor([0, 161], dtype=torch.int32),
        torch.from_numpy(codes), torch.tensor([120], dtype=torch.int32),
        torch.from_numpy(tcat), torch.from_numpy(gs),
        torch.from_numpy(jverify.mismatch_budget_table(1.0, max_rl)), 0, width, max_rl)
    keep, nx, g, s = (x.tolist() for x in out)
    assert keep == [False, True] and g == [0, 1] and s[1] == 1 and nx[1] == 0


@pytest.mark.parametrize("ngenes", [1, 2, 7, 300])
def test_gene_of_pos_matches_jax(ngenes):
    rng = np.random.default_rng(ngenes)
    s = 20_000
    cuts = np.sort(rng.choice(np.arange(1, s), ngenes - 1, replace=False))
    gs = np.concatenate([[0], cuts, [s]]).astype(np.int32)
    p = rng.integers(0, s, 5000).astype(np.int32)
    p[:4] = [0, s - 1, gs[-2], max(gs[-2] - 1, 0)]
    exp = np.asarray(jpacked.gene_of_pos(jnp.asarray(gs), jnp.asarray(p)))
    got = tpacked.gene_of_pos(torch.from_numpy(gs), torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(got, exp)
    np.testing.assert_array_equal(got, np.searchsorted(gs, p, side="right") - 1)


@pytest.mark.parametrize("lmax,l", [(1, 1), (37, 37), (100, 64), (200, 200)])
def test_unpack_rows_matches_jax(lmax, l):
    rng = np.random.default_rng(lmax)
    codes = rng.integers(0, 16, (50, lmax)).astype(np.uint8)
    rp = jpacked.pack_rows_np(codes)
    exp = np.asarray(jpacked.unpack_rows(jnp.asarray(rp), l))
    got = tpacked.unpack_rows(torch.from_numpy(rp.view(np.int32)), l)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), exp)
    np.testing.assert_array_equal(got.numpy(), codes[:, :l])


def _packed_tables(tcat, gs, codes, s):
    rpacked = tpacked.pack_rows(torch.from_numpy(codes))
    tp = torch.from_numpy(tpacked.pack_stream(tcat).view(np.int32))
    trows = tpacked.build_trows(tp, rpacked.shape[1], s)
    gb, steps = tpacked.build_gene_block(gs, s)
    return rpacked, trows, torch.from_numpy(gb), steps


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("q1", [0, 3, 9])
def test_verify_pairs_packed_matches_reference(seed, q1):
    """One window offset for all lanes, and (seed 2) one lane a lane."""
    width, max_rl, s = 7, 150, 4000
    tcat, gs, codes, lengths, r, p = _case(10 * seed + q1, q1, width, max_rl, s=s)
    budget = torch.from_numpy(jverify.mismatch_budget_table(0.9, max_rl))
    rpacked, trows, gblock, steps = _packed_tables(tcat, gs, codes, s)
    rt, pt, lt, gst = (torch.from_numpy(x) for x in (r, p, lengths, gs))
    q1s = torch.full(r.shape, q1, dtype=torch.int32) if seed == 2 else q1
    kp, nxp, gp, sp = tpacked.verify_pairs_packed(
        rt, pt, rpacked, lt, gst, budget, q1s, width, max_rl, s, trows, gblock, steps)
    kb, nxb, gb, sb = tverify.verify_pairs_dynq(
        rt, pt, torch.from_numpy(codes), lt, torch.from_numpy(tcat), gst, budget, q1,
        width, max_rl)
    np.testing.assert_array_equal(kp.numpy(), kb.numpy())
    np.testing.assert_array_equal(nxp[kp].numpy(), nxb[kb].numpy())
    np.testing.assert_array_equal(gp.numpy(), gb.numpy())
    np.testing.assert_array_equal(sp.numpy(), sb.numpy())
    assert kb.sum() > 20


@pytest.mark.parametrize("seed", range(3))
def test_verify_diagonals_packed_matches_reference(seed):
    """Bit k of a diagonal's okbits is the reference's keep of the pair at
    window offset q1s[k] on that diagonal; nx, gene and start agree on
    every diagonal some window keeps.  Lanes sorted by diagonal, as the
    engine feeds them, across irregular genes and stream edges."""
    width, max_rl, s = 9, 72, 5000
    rng = np.random.default_rng(100 + seed)
    cuts = np.sort(rng.choice(np.arange(1, s), 40, replace=False))
    gs = np.concatenate([[0], cuts, [s]]).astype(np.int32)
    q1s = (0, 2, 11)
    tcat, _, codes, lengths, r, p = _case(200 + seed, max(q1s), width, max_rl, 2048, s, gs)
    # The diagonals of _case's sites; inactive lanes stay inactive at
    # every window offset.
    d = np.where(p >= 0, np.clip(p - max(q1s), 0, s - 1 - max(q1s)), -100).astype(np.int32)
    d[:3] = [0, 1, s - 1 - max(q1s)]
    d[5::29] = rng.choice(gs[:-1], len(d[5::29]))  # gene starts: the pos-0 quirk
    order = np.lexsort((r, d))
    r, d = r[order], d[order]
    budget = torch.from_numpy(jverify.mismatch_budget_table(0.9, max_rl))
    rpacked, trows, gblock, steps = _packed_tables(tcat, gs, codes, s)
    rt, dt, lt, gst = (torch.from_numpy(x) for x in (r, d, lengths, gs))
    nx, g, sl, okbits = tpacked.verify_diagonals_packed(
        rt, dt, rpacked, lt, gst, budget, q1s, width, s, trows, gblock, steps)
    any_ok = np.zeros(len(r), bool)
    for k, q1 in enumerate(q1s):
        kb, nxb, gb, sb = tverify.verify_pairs_dynq(
            rt, dt + q1, torch.from_numpy(codes), lt, torch.from_numpy(tcat), gst, budget,
            q1, width, max_rl)
        bit = ((okbits.numpy() >> k) & 1).astype(bool)
        np.testing.assert_array_equal(bit, kb.numpy(), err_msg=f"window {k}")
        np.testing.assert_array_equal(nx[kb].numpy(), nxb[kb].numpy())
        np.testing.assert_array_equal(g[kb].numpy(), gb[kb].numpy())
        np.testing.assert_array_equal(sl[kb].numpy(), sb[kb].numpy())
        any_ok |= bit
    assert any_ok.sum() > 20
