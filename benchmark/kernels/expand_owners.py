"""B2: ``pipeline.KERNELS["expand_owners"]`` (csrc/expand.cu through ops/expand.py)."""

from benchmark.harness import work

SYMBOL = "expand_owners_kernel"


def call_work(args, kw) -> tuple:
    return work.call_work("expand_owners", args, kw)
