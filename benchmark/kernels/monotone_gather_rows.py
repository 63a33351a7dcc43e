"""B4: ``pipeline.KERNELS["monotone_gather_rows"]`` (csrc/gather.cu through ops/gather.py)."""

from benchmark.harness import work

SYMBOL = "gather_rows_kernel"


def call_work(args, kw) -> tuple:
    return work.call_work("monotone_gather_rows", args, kw)
