"""B3, the element gather (``csrc/gather.cu`` gather_kernel), on the card:
every output exact against the numpy oracle ``gather_cases.expected``
(``table[clip(idx, 0, n - 1)]``: the kernel clamps an index outside the
table, which the plain twin refuses) for every case of tests/gather_cases.py (monotone, step-backs,
scattered, one index, clamped indices, m from 0 to 40 and near multiples
of the run, a one-entry table), with the indices 0-3 words past a 16-byte
boundary, through the wrapper and through the launcher into an output 0-3
words past one, whose neighbouring words stay as they were.  Every test is
marked ``gpu`` and skips without a card.  The file imports nothing of JAX,
so it runs on a card machine without it:
``python -m pytest --noconftest -m gpu tests/test_torch_gather_cuda.py``
(the conftest pins JAX to the CPU).
"""

import pytest
import torch

from muscato_tpu_torch.ops import _lib, gather
from gather_cases import CASES, expected, gather_inputs

SENTINEL = -123456789


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_monotone_gather_matches_twin(cuda_device, case):
    table, buf, idx_off, out_off = gather_inputs(case)
    m = CASES[case][2]
    exp = torch.from_numpy(expected(table, buf[idx_off: idx_off + m]))
    table, buf = torch.from_numpy(table), torch.from_numpy(buf)
    table_d, buf_d = table.to(cuda_device), buf.to(cuda_device)
    idx_d = buf_d[idx_off: idx_off + m]
    assert idx_d.data_ptr() % 16 == 4 * idx_off

    before = gather.monotone_gather.launches
    got = gather.monotone_gather(table_d, idx_d)[0]
    assert gather.monotone_gather.launches == before + bool(m)
    assert torch.equal(got.cpu(), exp)

    # The launcher into an output 0-3 words past a 16-byte boundary.
    out = torch.full((out_off + m + 5,), SENTINEL, dtype=torch.int32, device=cuda_device)
    assert out.data_ptr() % 16 == 0
    if m:
        _lib.launch("monotone_gather", idx_d, table_d.data_ptr(), table_d.numel(),
                    idx_d.data_ptr(), m, out.data_ptr() + 4 * out_off)
    torch.cuda.synchronize()
    out = out.cpu()
    assert torch.equal(out[out_off: out_off + m], exp)
    assert (out[:out_off] == SENTINEL).all() and (out[out_off + m:] == SENTINEL).all()
