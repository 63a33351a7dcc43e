"""B3: ``pipeline.KERNELS["monotone_gather"]`` (csrc/gather.cu through ops/gather.py)."""

from benchmark.harness import work

SYMBOL = "gather_kernel"


def call_work(args, kw) -> tuple:
    return work.call_work("monotone_gather", args, kw)
