"""The port kernels that the roofline reads are those of
``pipeline.KERNELS``, each with a file of its own; a kernel with none, or
a launch that no wrapped call made, fails the traced run."""

import io
import os
import time

import pytest

from benchmark.bench_testing import tiny_copy
from benchmark.harness import profiling, runner


def test_every_port_kernel_has_a_file():
    from muscato_tpu_torch.engine import pipeline

    specs = profiling.kernel_specs()
    assert set(specs) == set(pipeline.KERNELS)
    for name, spec in specs.items():
        assert isinstance(spec.SYMBOL, str) and spec.SYMBOL and callable(spec.call_work), name


def test_a_kernel_without_a_file_fails_the_traced_run(tmp_path):
    root, bench, cell = tiny_copy(tmp_path, reads=1500, shift=50)
    os.remove(os.path.join(bench, "kernels", "verify_pairs.py"))
    with pytest.raises(RuntimeError, match="verify_pairs"):
        runner.run(root, cell, 7, 0.2, True, t_start=time.perf_counter(), device="cpu",
                   bench_dir=bench, out=io.StringIO(), err=io.StringIO())


def test_a_launch_no_wrapped_call_made_fails():
    from muscato_tpu_torch.engine import pipeline

    fn = pipeline.KERNELS["sorted_join"]
    with pytest.raises(RuntimeError, match="sorted_join"):
        with profiling.recorded_calls():
            fn.launches += 1
    fn.launches -= 1


def test_every_attribute_holding_a_wrapper_is_wrapped():
    """Each port module attribute that holds a kernel's wrapper is the
    hook inside the block and the wrapper again after it; a wrapper's own
    counters read through the hook."""
    import sys

    from muscato_tpu_torch.engine import pipeline
    from muscato_tpu_torch.ops import fused, join, packed

    held = [(m, a) for n, m in list(sys.modules.items()) if n.startswith("muscato_tpu_torch.")
            for a, v in vars(m).items() if any(v is fn for fn in pipeline.KERNELS.values())]
    assert (join, "sorted_join") in held and (fused, "verify_pairs_packed") in held
    with profiling.recorded_calls():
        for m, a in held:
            assert any(getattr(m, a).orig is fn for fn in pipeline.KERNELS.values())
        assert packed.verify_diagonals_swar.direct_launches == \
            pipeline.KERNELS["verify_diagonals_swar"].direct_launches
    for m, a in held:
        assert any(getattr(m, a) is fn for fn in pipeline.KERNELS.values())
