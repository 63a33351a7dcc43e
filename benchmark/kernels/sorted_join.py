"""B1: ``pipeline.KERNELS["sorted_join"]`` (csrc/join.cu through ops/join.py)."""

from benchmark.harness import work

SYMBOL = "sorted_join_kernel"


def call_work(args, kw) -> tuple:
    return work.call_work("sorted_join", args, kw)
