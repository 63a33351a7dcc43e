"""B7, the dedup verify's SWAR body (``csrc/verify.cu``), on the card:
every lane of the kernel exact against its plain twin
``verify_diagonals_swar_torch`` on the CPU, for the cases of
test_torch_verify_kernel.py and at the staged kernel's edges (a ragged
last tile, wholly dead tiles, one read a tile, odd and even read-row
strides, an odd t_rows width, reads long enough for each narrower tile,
the widest rows and the longest reads the launcher stages), and shapes
past shared memory (a t_rows column past the widest staged tile, reads of
1,000 words) on the direct route, one thread a lane with no shared
memory, counted apart.  Every test is marked ``gpu`` and skips
without a card.  The file imports nothing of JAX, so it runs on a card
machine without it: ``python -m pytest --noconftest -m gpu
tests/test_torch_verify_cuda.py`` (the conftest pins JAX to the CPU).
"""

import pytest
import torch

from muscato_tpu_torch.ops import packed as tpacked
from verify_cases import CASES, swar_args


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _on_card(args, dev, direct=False, **kw):
    """B7 on the card, one launch (on the direct route when ``direct``),
    every lane equal to its twin's on the CPU."""
    fn = tpacked.verify_diagonals_swar
    before = fn.launches, fn.direct_launches
    got = fn(*(x.to(dev) if torch.is_tensor(x) else x for x in args), **kw)
    assert (fn.launches, fn.direct_launches) == (before[0] + 1, before[1] + direct)
    for a, b in zip(got, tpacked.verify_diagonals_swar_torch(*args, **kw)):
        assert torch.equal(a.cpu(), b)


def _tile(nwords, tcols):
    """Lanes of the tile the launcher takes for this shape."""
    return tpacked.swar_tile(nwords, tcols)[0]


def _staged(nwords, tcols):
    """True when the launcher stages this shape in shared memory (its
    tile's bytes are not 0: the direct route's)."""
    return tpacked.swar_tile(nwords, tcols)[1] > 0


def _last_true(pred, lo):
    """The largest x >= lo with pred(x), for a pred that holds at lo and,
    past some x, never again."""
    hi = lo + 1
    while pred(hi):
        hi *= 2
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if pred(mid) else (lo, mid)
    return lo


@pytest.mark.gpu
def test_cuda_verify_kernel_matches_twin(cuda_device):
    """B7 on the card, exact against its twin on every lane, for every
    case of test_torch_verify_kernel.py."""
    for seed, (width, q1s, nwords, lengths, x_rate) in enumerate(CASES.values()):
        args, s = swar_args(seed, nwords, lengths, x_rate, q1s)
        _on_card(args, cuda_device, width=width, smax=s)


# The staged kernel's edges: (read words, lanes, dead tail lanes, one read
# a tile, extra t_rows columns); the widest rows and the longest reads are
# asked of the launcher on the card.
EDGES = {
    "ragged last tile": (13, 3 * 256 + 77, None, False, 0),
    "wholly dead tiles": (13, 1280, 700, False, 0),
    "one read a tile": (13, 1024, None, True, 0),
    "4 words (even stride)": (4, 768, None, False, 0),
    "13 words": (13, 768, None, False, 0),
    "19 words": (19, 768, None, False, 0),
    "25 words": (25, 768, None, False, 0),
    "odd tcols": (13, 768, None, False, 1),
    "880-base reads": (110, 768, None, False, 0),
    "2000-base reads": (250, 768, None, False, 0),
    "4096-base reads": (512, 768, None, False, 0),
    "widest tile that fits": (13, 768, None, False, "widest"),
    "longest read whose tile fits": ("longest", 512, None, False, 0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("edge", list(EDGES))
def test_cuda_verify_kernel_edges(cuda_device, edge):
    """B7's tiles at their edges, exact against the twin on every lane: a
    lane count that is not a multiple of the tile, tiles that are wholly
    dead tail, a tile whose lanes share one read, odd and even read-row
    strides, an odd t_rows width, reads up to the packed path's 4096
    bases, and the largest shapes the launcher takes (t_rows widened to
    the last width that fits; the longest reads whose natural rows fit)."""
    nwords, n, ndead, tile_read, widen = EDGES[edge]
    if nwords == "longest":
        nwords = _last_true(lambda w: _staged(w, w + tpacked.TROWS_GUARD), 13)
    if widen == "widest":
        widen = _last_true(lambda t: _staged(nwords, t), nwords + tpacked.TROWS_GUARD) - (
            nwords + tpacked.TROWS_GUARD)
    args, s = swar_args(len(edge), nwords, (20, 8 * nwords), 0.02, (0, 10, 30, 50), n=n,
                        ndead=ndead, tile_read=tile_read, widen=widen)
    assert _staged(nwords, args[2].shape[1])
    _on_card(args, cuda_device, width=20, smax=s)


@pytest.mark.gpu
def test_cuda_verify_tile_narrows_with_the_rows(cuda_device):
    """The launcher takes tiles of 256 lanes at the flagship's rows and
    narrower ones, never wider, as the reads grow, through the packed
    path's longest reads (4096 bases, 512 words)."""
    tiles = [_tile(w, w + tpacked.TROWS_GUARD) for w in range(1, 513)]
    assert tiles[12] == 256 and tiles[-1] >= 32
    assert all(a >= b for a, b in zip(tiles, tiles[1:]))
    assert set(tiles) <= {256, 128, 64, 32}
    assert all(_staged(w, w + tpacked.TROWS_GUARD) for w in range(1, 513))


@pytest.mark.gpu
def test_cuda_verify_kernel_refuses_a_tile_past_shared_memory(cuda_device):
    """Shapes whose 32-lane tile does not fit in shared memory: one t_rows
    column past the widest staged tile at 13-word reads, and reads of
    1,000 words (8,000 bases) at B4's rows.  The launcher refuses neither:
    it takes the direct kernel (a tile of 0 bytes), one launch each,
    counted in ``direct_launches``, exact against the twin on every
    lane."""
    nwords = 13
    widest = _last_true(lambda t: _staged(nwords, t), nwords + tpacked.TROWS_GUARD)
    assert not _staged(nwords, widest + 1)
    args, s = swar_args(3, nwords, (20, 104), 0.02, (10, 30), n=512,
                        widen=widest + 1 - nwords - tpacked.TROWS_GUARD)
    _on_card(args, cuda_device, direct=True, width=20, smax=s)
    assert not _staged(1000, 1000 + tpacked.TROWS_GUARD)
    args, s = swar_args(4, 1000, (20, 8000), 0.02, (0, 2000, 4000, 6000), n=600)
    _on_card(args, cuda_device, direct=True, width=20, smax=s)
