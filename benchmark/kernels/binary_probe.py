"""B9: ``pipeline.KERNELS["binary_probe"]`` (csrc/probe.cu through ops/search.py)."""

from benchmark.harness import work

SYMBOL = "binary_probe_kernel"


def call_work(args, kw) -> tuple:
    return work.call_work("binary_probe", args, kw)
