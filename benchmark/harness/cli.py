"""One run of one cell: refuse without the cards the cell needs, set up,
measure the window, read the peak memory, refuse if JAX was loaded, check
the outputs against the reference, and print the result line."""

from __future__ import annotations

import argparse
import importlib
import json
import math
import sys
import time
import traceback
from pathlib import Path

from harness import spec as specmod
from harness.record import Run

# whole top-level module names that no process of the benchmark may load
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "kinpoly_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN (compared
    whole: ``kinpoly_tpu_torch`` is not ``kinpoly_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def require_cards(n: int) -> None:
    """Raise unless torch sees at least n CUDA devices: no run falls back
    to the CPU."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("benchmark: no CUDA device (torch.cuda.is_available() "
                         "is false); nothing measured")
    if torch.cuda.device_count() < n:
        raise SystemExit(f"benchmark: the cell needs {n} CUDA devices, torch "
                         f"sees {torch.cuda.device_count()}; nothing measured")


def require_program(root: Path) -> None:
    if not (root / "kinpoly_tpu_torch" / "__init__.py").exists():
        raise SystemExit(f"benchmark: no kinpoly_tpu_torch package under "
                         f"{root}; nothing measured")


def make_loop(cell, seed: int, device: str, precision: str = "float32",
              fault: str | None = None):
    mod = importlib.import_module(f"harness.loops.{cell.traffic['loop']}")
    return mod.Loop(cell, seed, device=device, precision=precision,
                    fault=fault)


def execute(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
            precision: str = "float32", t_start: float | None = None,
            fault: str | None = None, profile: bool = True):
    """Set-up, window and check of one cell; returns (result dict, checks).
    `precision` "tf32" runs the program with TF32 matmuls (the control);
    `fault` plants one of ``faults.FAULTS`` under the timed path;
    `profile` False leaves out the profiled iteration after the window
    (for readings of the compared numbers alone)."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    run = Run(config=cell.config, traffic=cell.traffic, seconds=seconds,
              trace=trace)
    loop = make_loop(cell, seed, device, precision, fault)
    loop.setup()
    if device == "cuda":
        torch.cuda.synchronize()
    run.setup_s = time.perf_counter() - t_start
    loop.window(run, seconds, profile=profile and device == "cuda")
    peak = 0
    if device == "cuda":
        torch.cuda.synchronize()
        peak = max(torch.cuda.max_memory_allocated(i)
                   for i in range(torch.cuda.device_count()))
    loop.release()
    checks = loop.check()
    return run, loop, checks, peak


def result_line(cell, run, loop, checks, peak, device_info: dict) -> dict:
    metrics = {}
    entries = run.trace and cell.per_layer or cell.end_to_end
    for m in entries:
        v = specmod.reader(m["name"])(run)
        if v is None:
            continue
        metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    correct = bool(checks) and all(
        math.isfinite(c[1]) and c[1] <= c[2] for c in checks)
    line = {"correct": correct, "attempted": loop.attempted,
            "failed": loop.failed, "metrics": metrics, "device": device_info}
    if run.trace and run.profile is not None:
        line["device"] = dict(device_info, busy_s=run.profile.busy_s,
                              window_s=run.profile.window_s)
        line["breakdown"] = run.profile.breakdown()
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, value, limit in checks}
    return line


def main(argv, t_start: float | None = None) -> int:
    args = parse(argv)
    root = specmod.BENCH_DIR.parent
    try:
        require_program(root)
        bench = specmod.load_json(root / "BENCHMARK.json")
        cell = specmod.find_cell(bench, args.workload)
        require_cards(cell.workload["chips"])
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 2
    import torch
    try:
        run, loop, checks, peak = execute(cell, args.seed, args.seconds,
                                          bool(args.trace), t_start=t_start)
    except Exception:
        traceback.print_exc()
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}; no result", file=sys.stderr)
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cell.workload["chips"], "memory_peak_bytes": int(peak)}
    line = result_line(cell, run, loop, checks, peak, info)
    units = [round(u.t1 - u.t0, 3) for u in run.units]
    print(f"units (s): {units}", file=sys.stderr)
    print(f"window rate (work/s): {run.rate()!r}", file=sys.stderr)
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
