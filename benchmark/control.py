"""Read a cell's compared numbers over many seeds in one process: the
program as it runs (``float32``, the lower readings), the control (``tf32``:
the program with TF32 matmuls in place of the configuration's float32) or
the program with a fault of ``harness/faults.py`` planted (the upper
readings). Each seed runs the cell's set-up, whose first iteration the
check compares, and a window of ``--seconds`` (one checked iteration
where the window holds one; none by default).

    python3 benchmark/control.py --workload uhc.train.e1024 \\
        --modes tf32 half_unstepped --seeds 11 12 13 --seconds 1

Prints one JSON line per mode and seed: {"seed", "mode", "checks": {name:
value}}. Needs a CUDA device.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (HERE, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def main(argv=None) -> int:
    from harness import cli, faults, spec

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--modes", nargs="+", default=["float32"],
                   choices=("float32", "tf32") + faults.FAULTS)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=0.0,
                   help="a window before the check (default: none)")
    args = p.parse_args(argv)
    cell = spec.find_cell(spec.load_json(spec.BENCH_DIR.parent
                                         / "BENCHMARK.json"), args.workload)
    cli.require_cards(cell.workload["chips"])
    for mode in args.modes:
        fault = mode if mode in faults.FAULTS else None
        precision = "tf32" if mode == "tf32" else "float32"
        for seed in args.seeds:
            t0 = time.perf_counter()
            run, loop, checks, peak = cli.execute(
                cell, seed, args.seconds, False, precision=precision,
                fault=fault, profile=False)
            print(json.dumps({"seed": seed, "mode": mode,
                              "setup_s": run.setup_s,
                              "seconds": time.perf_counter() - t0,
                              "checks": {n: v for n, v, _ in checks}}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
