"""B5, the window-query kernel (``csrc/windows.cu``), on the card past its
window table: 65 and 130 windows, which the wrapper launches in groups of
at most 64 (two and three launches), every output of every (window, read)
exact against the plain twin ``window_queries_torch`` on the CPU, at a
hashed width with the dinucleotide gate and at an exact width without it,
over reads of ragged lengths and an odd row width.  Every test is marked
``gpu`` and skips without a card.  The file imports nothing of JAX, so it
runs on a card machine without it:
``python -m pytest --noconftest -m gpu tests/test_torch_windows_cuda.py``
(the conftest pins JAX to the CPU).
"""

import numpy as np
import pytest
import torch

from muscato_tpu_torch.ops import packed, window_queries as wq


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _reads(nreads, nbases, seed):
    """(rpacked, lengths) of ``nreads`` reads of 20 to ``nbases`` bases,
    codes 0-3 with X at 2%, zero past each read's length."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (nreads, nbases)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.02] = 4
    lengths = rng.integers(20, nbases + 1, nreads).astype(np.int32)
    codes[np.arange(nbases)[None, :] >= lengths[:, None]] = 0
    return packed.pack_rows(torch.from_numpy(codes)), torch.from_numpy(lengths)


@pytest.mark.gpu
@pytest.mark.parametrize("nwin,launches", [(65, 2), (130, 3)])
@pytest.mark.parametrize("width,min_dinuc", [(20, 3), (13, 0)])
def test_cuda_window_queries_in_groups(cuda_device, nwin, launches, width, min_dinuc):
    rp, ln = _reads(3001, 296, nwin + width)  # 37 words a row
    q1s = tuple(range(0, 2 * nwin, 2))
    before = wq.window_queries.launches
    got = wq.window_queries(rp.to(cuda_device), ln.to(cuda_device), q1s, width=width,
                            min_dinuc=min_dinuc)
    assert wq.window_queries.launches == before + launches
    exp = wq.window_queries_torch(rp, ln, q1s, width=width, min_dinuc=min_dinuc)
    for name, a, b in zip(("key1", "key2", "valid"), got, exp):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b), name
    assert exp[2].any() and not exp[2].all()
