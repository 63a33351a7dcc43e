"""B8 and B9, the search probe's kernels (``csrc/probe.cu``: the
direct-bucket probe and the bucketed binary search), on the card: every
query's (count, loc) exact against the plain twins on the CPU, on the
branch cases of tests/probe_cases.py (empty buckets, buckets of 1 and 16
records, the last bucket, queries past the last key, invalid queries,
widths with and without the second key word, the padding records' keys,
a binary table that needs every search step, unsorted queries); the
search aux built on the card equal to the CPU's; and the shapes the
kernels refuse.  Every test is marked ``gpu`` and skips without a card.
The file imports nothing of JAX: ``python -m pytest --noconftest -m gpu
tests/test_torch_probe_cuda.py``.
"""

import pytest
import torch

import probe_cases
from muscato_tpu_torch.engine import index as tindex
from muscato_tpu_torch.ops import search as tsearch

_WRAPPERS = {"direct": (tsearch.direct_probe, tsearch.direct_probe_torch),
             "binary": (tsearch.binary_probe, tsearch.binary_probe_torch)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _to(args, dev):
    return tuple(a.to(dev) for a in args)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(probe_cases.cases()))
def test_cuda_probe_kernels_match_twins(cuda_device, case):
    kind, aux, width, q = probe_cases.cases()[case]
    args, kw = probe_cases.probe_args(kind, aux, width, q)
    kernel, twin = _WRAPPERS[kind]
    before = kernel.launches
    got = kernel(*_to(args, cuda_device), **kw)
    assert kernel.launches == before + 1
    for a, b in zip(got, twin(*args, **kw)):
        assert torch.equal(a.cpu(), b)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["direct", "binary"])
def test_cuda_aux_build_matches_cpu(cuda_device, mode):
    """build_search_aux_device on the card equals its run on the CPU."""
    _, aux, width, _ = probe_cases.cases()[f"w20 {mode}"]
    # The sorted table again: each unique key repeated its count.
    if mode == "direct":
        rec = aux.urec.view(-1, 4)[:-16]
        uk1, uk2, cnt = rec[:, 0], rec[:, 1], rec[:, 3]
    else:
        uk1, uk2, cnt = aux.ukeys, aux.ukeys2, aux.ucount
    k1, k2 = uk1.repeat_interleave(cnt), uk2.repeat_interleave(cnt)
    cap = None if mode == "direct" else 0
    exp = probe_cases.aux_of(k1.numpy().view("uint32"), k2.numpy().view("uint32"), width, cap)
    saved = tindex.MAX_DIRECT_BITS
    tindex.MAX_DIRECT_BITS = saved if cap is None else cap
    try:
        got = tindex.build_search_aux_device(k1.to(cuda_device), k2.to(cuda_device), width)
    finally:
        tindex.MAX_DIRECT_BITS = saved
    assert (got.mode, got.bucket_bits, got.upshift, got.probe_steps) == (
        exp.mode, exp.bucket_bits, exp.upshift, exp.probe_steps) and got.mode == mode
    for name in ("sbucket", "urec", "ukeys", "ukeys2", "ustart", "ucount", "ukk"):
        a, b = getattr(got, name), getattr(exp, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a.cpu(), b), name


@pytest.mark.gpu
def test_cuda_probe_kernels_refuse(cuda_device):
    """What the kernels do not take raises, with no fallback to a twin:
    a bucket width past 16 records, probe steps past 32 and records that
    are not 16-byte aligned (the launcher's refusal), a bucket table of
    another size than the bits give (the wrapper's)."""
    kind, aux, width, q = probe_cases.cases()["w20 direct"]
    args, kw = probe_cases.probe_args(kind, aux, width, q)
    args = _to(args, cuda_device)
    with pytest.raises(RuntimeError, match="direct_probe: CUDA kernel launch failed"):
        tsearch.direct_probe(*args, **dict(kw, bucket_width=17))
    urec = torch.empty(args[3].numel() + 1, dtype=torch.int32, device=cuda_device)[1:]
    with pytest.raises(RuntimeError, match="direct_probe: CUDA kernel launch failed"):
        tsearch.direct_probe(*args[:3], urec, args[4], **kw)
    with pytest.raises(ValueError, match="sbucket"):
        tsearch.direct_probe(*args[:4], args[4][:-1], **kw)
    kind, aux, width, q = probe_cases.cases()["w20 binary"]
    args, kw = probe_cases.probe_args(kind, aux, width, q)
    with pytest.raises(RuntimeError, match="binary_probe: CUDA kernel launch failed"):
        tsearch.binary_probe(*_to(args, cuda_device), **dict(kw, probe_steps=33))
