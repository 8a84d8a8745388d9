"""Run one cell of ``BENCHMARK.json`` once, on the card it is started on:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The last line of standard output is the result (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``; the compared numbers and their limits last, under
``checks``); the compared numbers are also the last lines of standard
error.  Exits non-zero, printing no result, without the CUDA devices the
cell asks for, or if the process holds JAX or the JAX package when the
run is over.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], harness.process_start()))
