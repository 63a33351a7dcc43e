"""B7: ``pipeline.KERNELS["verify_diagonals_swar"]`` (csrc/verify.cu through ops/packed.py)."""

from benchmark.harness import work

SYMBOL = "verify_diagonals_kernel"


def call_work(args, kw) -> tuple:
    return work.call_work("verify_diagonals_swar", args, kw)
