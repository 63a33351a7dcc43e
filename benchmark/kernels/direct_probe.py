"""B8: ``pipeline.KERNELS["direct_probe"]`` (csrc/probe.cu through ops/search.py)."""

from benchmark.harness import work

SYMBOL = "direct_probe_kernel"


def call_work(args, kw) -> tuple:
    return work.call_work("direct_probe", args, kw)
