#!/usr/bin/env python3
"""Run one cell of the benchmark of muscato_tpu_torch on this machine's GPU.

    python3 benchmark/run.py --workload <config>.<traffic> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result as one JSON object; the numbers compared with the reference, each
beside its limit, are the last lines of standard error.  See
``harness/runner.py``.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import runner  # noqa: E402

if __name__ == "__main__":
    sys.exit(runner.main(sys.argv[1:], T_START))
