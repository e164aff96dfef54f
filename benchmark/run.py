"""Benchmark of ls1_mardyn_tpu_torch on NVIDIA GPUs: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Prints as its last line one JSON
object: correct, attempted, failed, metrics (--trace 0: the cell's
end-to-end metrics; --trace 1: its per-layer metrics and a breakdown),
device, and last the checks, each number beside its limit (also the
last lines of standard error).  Exits non-zero without a result when
the card is missing, the run measured another path than its cell, or
JAX or the JAX package was loaded.  See harness.py.
"""

import time

T0 = time.time()  # set-up is counted from here

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
