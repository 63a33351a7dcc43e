"""B3, the element gather (``ops/gather.py`` monotone_gather), on the CPU:
the wrapper's plain twin against the JAX package's Pallas kernel
(``muscato_tpu/ops/pallas_gather.py`` monotone_gather, in interpret mode,
its window the whole table so that no block overflows) and its numpy
oracle on every case of tests/gather_cases.py, and a model of how the CUDA
kernel splits the outputs among its threads (a scalar head up to out's
16-byte boundary, runs of four, a scalar tail, a grid striding over the
runs) that writes every output exactly once with aligned vector accesses.
The kernel itself runs only on the card (test_torch_gather_cuda.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from muscato_tpu.ops import pallas_gather as pg
from muscato_tpu_torch.ops import gather
from gather_cases import CASES, expected, gather_inputs, split_model


@pytest.mark.parametrize("case", list(CASES))
def test_monotone_gather_twin_matches_jax(case):
    """Every output of the twin equals the Pallas kernel's and the numpy
    oracle's on the case's indices clamped to the table, as the contract
    has them in range; the CPU launches nothing.  Where the case's indices
    leave the table, the twin refuses them as they are."""
    table, buf, idx_off, _ = gather_inputs(case)
    m = CASES[case][2]
    idx = buf[idx_off: idx_off + m]
    clamped = np.clip(idx, 0, len(table) - 1).astype(np.int32)
    table_t = torch.from_numpy(table)
    if CASES[case][3] == "clamped":
        assert (idx >= len(table)).any()
        with pytest.raises(IndexError):
            gather.monotone_gather(table_t, torch.from_numpy(buf)[idx_off: idx_off + m])
    before = gather.monotone_gather.launches
    got, of = gather.monotone_gather(table_t, torch.from_numpy(clamped))
    assert gather.monotone_gather.launches == before and of == 0
    assert got.dtype == torch.int32 and got.shape == (m,)
    np.testing.assert_array_equal(got.numpy(), pg.monotone_gather_np(table, clamped))
    np.testing.assert_array_equal(got.numpy(), expected(table, idx))
    if m:
        window = -(-len(table) // pg.LANE) * pg.LANE
        out_p, of_p = pg.monotone_gather(jnp.asarray(table), jnp.asarray(clamped),
                                         window=window, interpret=True)
        assert int(of_p) == 0
        np.testing.assert_array_equal(got.numpy(), np.asarray(out_p))


def test_gather_split_writes_every_output_once():
    """The kernel's head / runs / tail split at every case's m and offsets
    and at every pair of offsets for m of 1,021-1,030 (around four CTAs'
    runs): every output written exactly once, every 16-byte index load and
    store on a 16-byte boundary, and the index loads vectorised exactly
    when idx and out share their offset."""
    shapes = {(c[2], c[4], c[5]) for c in CASES.values()}
    shapes |= {(m, i, o) for m in range(1021, 1031) for i in range(4) for o in range(4)}
    for m, idx_off, out_off in sorted(shapes):
        writes, loads, stores = split_model(m, idx_off, out_off)
        assert (writes == 1).all(), (m, idx_off, out_off)
        assert all(w % 4 == 0 for w in loads + stores), (m, idx_off, out_off)
        if m >= 7:
            assert stores and bool(loads) == (idx_off == out_off), (m, idx_off, out_off)

