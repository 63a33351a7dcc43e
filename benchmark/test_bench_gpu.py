"""A tiny cell, and its control, on the card (skipped without one)."""

import io
import time

import pytest
import torch

from benchmark.bench_testing import result_line, tiny_copy
from benchmark.harness import runner


@pytest.mark.gpu
@pytest.mark.parametrize("control", [None, "budget-1"])
def test_tiny_cell_on_the_card(tmp_path, control):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    root, bench, cell = tiny_copy(tmp_path, reads=20_000, shift=1000)
    out = io.StringIO()
    rc = runner.run(root, cell, 2**31 + 17, 2, True, t_start=time.perf_counter(),
                    bench_dir=bench, out=out, control=control)
    line = result_line(out.getvalue())
    assert rc == 0 and line["device"]["platform"] == "gpu"
    assert line["correct"] is (control is None)
    assert line["device"]["busy_s"] > 0
