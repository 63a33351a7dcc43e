"""B8 and B9, the search probe's kernels (``csrc/probe.cu``: the
direct-bucket probe and the bucketed binary search), on the card: every
query's (count, loc) exact against the plain twins on the CPU, on the
branch cases of tests/probe_cases.py (empty buckets, buckets of 1 and 16
records, the last bucket, queries past the last key, invalid queries,
widths with and without the second key word, the padding records' keys,
a binary table that needs every search step, unsorted queries, a bucket
of exactly 16 records, a binary bucket of 2**probe_steps - 1 keys), by
the default build and by the -DMUSCATO_NO_STAGE build of csrc/probe.cu
(the first design's one-thread kernels, which chip_smoke.py times beside
it); B9 with fewer rounds than its largest bucket needs; the search
aux built on the card equal to the CPU's; and the shapes the kernels
refuse.  Every test is marked ``gpu`` and skips without a card.
The file imports nothing of JAX: ``python -m pytest --noconftest -m gpu
tests/test_torch_probe_cuda.py``.
"""

import functools
import os

import pytest
import torch

import probe_cases
from muscato_tpu_torch.engine import index as tindex
from muscato_tpu_torch.ops import _lib
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
    got = kernel(*probe_cases.to_device(kind, args, cuda_device), **kw)
    assert kernel.launches == before + 1
    for a, b in zip(got, twin(*args, **kw)):
        assert torch.equal(a.cpu(), b)


@functools.lru_cache(maxsize=None)
def _unstaged():
    """csrc/probe.cu alone, built with -DMUSCATO_NO_STAGE."""
    path, _, _ = _lib._build(_lib.NVCC_FLAGS + ("-DMUSCATO_NO_STAGE",),
                             [os.path.join(_lib.CSRC, "probe.cu")])
    return _lib.load(path)


@pytest.mark.gpu
def test_cuda_probe_unstaged_build_matches_twins(cuda_device):
    """The -DMUSCATO_NO_STAGE build's B8 and B9, one thread a query
    (launched as the wrappers launch the default ones), on every branch
    case, exact against the twins."""
    lib = _unstaged()
    for case, (kind, aux, width, q) in probe_cases.cases().items():
        args, kw = probe_cases.probe_args(kind, aux, width, q)
        dev_args = probe_cases.to_device(kind, args, cuda_device)
        if kind == "direct":
            got = tsearch._launch_direct(*dev_args, **kw, lib=lib)
            exp = tsearch.direct_probe_torch(*args, **kw)
        else:
            keyf, key2f, validf, ukeys, _, ukk, ustart, _, sbucket = dev_args
            got = tsearch._launch_binary(keyf, key2f, validf, ukk, ustart, ukeys.numel(),
                                         sbucket, **kw, lib=lib)
            exp = tsearch.binary_probe_torch(*args, **kw)
        for a, b in zip(got, exp):
            assert torch.equal(a.cpu(), b), case


@pytest.mark.gpu
@pytest.mark.parametrize("steps", [0, 1, 3, 5])
def test_cuda_binary_probe_fewer_steps_matches_twin(cuda_device, steps):
    """B9 with fewer rounds than its largest bucket (63 keys) needs: the
    twin's search stops short for some queries, and the kernel's replay of
    its rounds with it."""
    kind, aux, width, q = probe_cases.cases()["a binary bucket of 2**probe_steps - 1 keys"]
    args, kw = probe_cases.probe_args(kind, aux, width, q)
    kw["probe_steps"] = steps
    got = tsearch.binary_probe(*probe_cases.to_device(kind, args, cuda_device), **kw)
    for a, b in zip(got, tsearch.binary_probe_torch(*args, **kw)):
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
    a bucket width past 16 records, probe steps past 32, records that are
    not 16-byte aligned and (start, count) pairs that are not 8-byte
    aligned (the launcher's refusal), a bucket table of another size than
    the bits give, starts and counts that are not the columns of one pair
    tensor (the wrapper's)."""
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
    args = probe_cases.to_device(kind, args, cuda_device)
    with pytest.raises(RuntimeError, match="binary_probe: CUDA kernel launch failed"):
        tsearch.binary_probe(*args, **dict(kw, probe_steps=33))
    ustart, ucount = args[6], args[7]
    odd = torch.empty(2 * ustart.numel() + 1, dtype=torch.int32, device=cuda_device)
    pairs = odd[1:].view(-1, 2)
    pairs[:, 0], pairs[:, 1] = ustart, ucount
    with pytest.raises(RuntimeError, match="binary_probe: CUDA kernel launch failed"):
        tsearch.binary_probe(*args[:6], pairs[:, 0], pairs[:, 1], args[8], **kw)
    with pytest.raises(ValueError, match="columns"):
        tsearch.binary_probe(*args[:6], ustart.contiguous(), ucount.contiguous(), args[8], **kw)
