"""B10: ``pipeline.KERNELS["verify_pairs"]`` (csrc/verify.cu through ops/packed.py)."""

from benchmark.harness import work

SYMBOL = "verify_pairs_kernel"


def call_work(args, kw) -> tuple:
    return work.call_work("verify_pairs", args, kw)
