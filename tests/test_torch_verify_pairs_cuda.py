"""B10, the streaming expand's per-pair verify (``csrc/verify.cu``
``verify_pairs_kernel``), on the card: every lane of the kernel exact
against its plain twin ``verify_pairs_packed_torch`` on the CPU, for every
case of tests/verify_pairs_cases.py (among them the edges of its warp
tiles: lane counts that are no multiple of a warp or below one, dead
warps, lanes that share a read row, 512-word reads), at a lane count that
is not a multiple of the block, with the window offset as a scalar, as
one 0-d tensor and as one a lane, and at the longest reads whose tile
fits shared memory, and past it (908 and 1,000 words) on the direct
route, one thread a lane with no shared memory, counted apart; trows
narrower than the reads need are refused.  Every test is marked ``gpu``
and skips
without a card.  The file
imports nothing of JAX, so it runs on a card machine without it:
``python -m pytest --noconftest -m gpu tests/test_torch_verify_pairs_cuda.py``
(the conftest pins JAX to the CPU).
"""

import pytest
import torch

from muscato_tpu_torch.ops import packed as tpacked
from verify_pairs_cases import CASES, pair_args


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _to(args, dev):
    return [x.to(dev) if torch.is_tensor(x) else x for x in args]


def _on_card(args, dev, direct=False):
    """B10 on the card, one launch (on the direct route when ``direct``),
    every output of every lane equal to the twin's on the CPU."""
    fn = tpacked.verify_pairs_packed
    before = fn.launches, fn.direct_launches
    got = fn(*_to(args, dev))
    assert (fn.launches, fn.direct_launches) == (before[0] + 1, before[1] + direct)
    exp = tpacked.verify_pairs_packed_torch(*args)
    for name, a, b in zip(("keep", "nx", "g", "s"), got, exp):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b), name
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_verify_pairs_matches_twin(cuda_device, case):
    """B10 exact against its twin on every lane of every case."""
    args, _ = pair_args(case)
    keep = _on_card(args, cuda_device)[0]
    assert int(keep.sum()) > (20 if keep.numel() >= 1024 else 0)


@pytest.mark.gpu
def test_cuda_verify_pairs_ragged_lanes_and_q1_forms(cuda_device):
    """A lane count that leaves the last block ragged; the per-lane offsets
    given as a scalar, a 0-d tensor and one a lane give one result."""
    args, _ = pair_args("w20-scalar-q1-10", n=3 * 256 + 77)
    got = _on_card(args, cuda_device)
    for q1 in (torch.tensor(10, dtype=torch.int32),
               torch.full((args[0].shape[0],), 10, dtype=torch.int32)):
        alt = _on_card(args[:6] + (q1,) + args[7:], cuda_device)
        for a, b in zip(got, alt):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_cuda_verify_pairs_refuses_narrow_rows(cuda_device):
    """trows one word narrower than nwords + 8: the launcher refuses it,
    the wrapper raises and counts no launch."""
    args, _ = pair_args("w20-4win-13words", n=512)
    trows = args[10]
    args = args[:10] + (trows[:, : args[2].shape[1] + 7].contiguous(),) + args[11:]
    before = tpacked.verify_pairs_packed.launches
    with pytest.raises(RuntimeError):
        tpacked.verify_pairs_packed(*_to(args, cuda_device))
    assert tpacked.verify_pairs_packed.launches == before


@pytest.mark.gpu
def test_cuda_verify_pairs_longest_reads_and_refusal(cuda_device):
    """Read rows of 907 words, the longest whose warp tile (its rows and
    target windows at odd strides) fits 232,448 bytes of shared memory,
    run staged; at 908 and 1,000 words the launcher refuses nothing: it
    takes the thread kernel (a tile of 0 bytes), counted in
    ``direct_launches``.  Each exact against the twin on every lane."""
    args, _ = pair_args("w20-4win-13words", n=256)
    g = torch.Generator().manual_seed(16)
    for nwords, staged in ((907, True), (908, False), (1000, False)):
        assert (tpacked.pairs_tile(nwords)[1] > 0) == staged
        rpacked = torch.randint(-2**31, 2**31, (args[2].shape[0], nwords), dtype=torch.int64,
                                generator=g).to(torch.int32)
        trows = torch.randint(-2**31, 2**31, (args[10].shape[0], nwords + 8),
                              dtype=torch.int64, generator=g).to(torch.int32)
        wide = args[:2] + (rpacked,) + args[3:10] + (trows,) + args[11:]
        _on_card(wide, cuda_device, direct=not staged)
