"""B5: ``pipeline.KERNELS["window_queries"]`` (csrc/windows.cu through ops/window_queries.py)."""

from benchmark.harness import work

SYMBOL = "window_queries_kernel"


def call_work(args, kw) -> tuple:
    return work.call_work("window_queries", args, kw)
