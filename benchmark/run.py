"""Run one cell of the benchmark of ``kinpoly_tpu_torch`` once.

    python3 benchmark/run.py --workload uhc.train.e1024 --seed 7 \\
        --seconds 51 --trace 0

From the root of a checkout that holds the port and ``BENCHMARK.json``:
loads and warms up the cell, measures for ``--seconds`` seconds, checks the
timed path's outputs against the frozen plain reference, and prints one
JSON line with ``correct``, ``attempted``, ``failed``, ``metrics`` and
``device`` (and, with ``--trace 1``, ``breakdown``). Needs a CUDA device.
"""

import os
import sys
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (HERE, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

if __name__ == "__main__":
    from harness import cli
    sys.exit(cli.main(sys.argv[1:], t_start=T_START))
