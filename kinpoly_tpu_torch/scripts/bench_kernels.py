#!/usr/bin/env python3
"""Time the kernels K1-K3 and K4a-c on the card, three ways.

    python kinpoly_tpu_torch/scripts/bench_kernels.py [--root DIR] [--envs N] [--only NAME]

``--root`` is the checkout whose ``kinpoly_tpu_torch`` and ``chip_smoke.py``
are timed (default: the one holding this script), so two versions can be
compared in one call on one card. The inputs are those of one captured
substep of N envs (default 2048, the main path's kernel shapes) in each
solver configuration, as ``chip_smoke.py`` builds them: K1-K3 from the
LTDL substep, K4a (R = 55 and 1) and K4b (R = 55, on K4a's inputs) from
the dense one, and K4c (R = 55 and 1) on K4a's inputs with the systems
factored by the plain version. For each kernel it prints one JSON line:

- ``wrapper_ms``: CUDA events around a run of eager wrapper calls, as
  ``chip_smoke.py`` times them: what a Python caller pays, the host's
  launch time where that is longer than the kernel's;
- ``graph_ms``: the same calls captured in one CUDA graph and replayed,
  CUDA events around the replay: the device time per launch;
- ``profiler_ms``: the mean duration that torch.profiler records for the
  kernel itself (not the conversions its wrapper may launch).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--envs", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--only", default="",
                    help="time only the kernels whose name starts with this")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("bench_kernels: needs a CUDA device")
    import chip_smoke
    import kinpoly_tpu_torch
    from kinpoly_tpu_torch import native, resolve_device
    from kinpoly_tpu_torch.anim.spec import synthetic_spec
    from kinpoly_tpu_torch.config.defaults import uhc_control_params
    from kinpoly_tpu_torch.physics import engine as eng
    from kinpoly_tpu_torch.physics import chol, chol_cuda, ltdl_cuda, pgs_cuda
    if not os.path.abspath(kinpoly_tpu_torch.__file__).startswith(root + os.sep):
        sys.exit(f"bench_kernels: imported {kinpoly_tpu_torch.__file__}, "
                 f"not from {root}")

    device = resolve_device("cuda")
    native.library()
    spec = synthetic_spec()
    model = eng.build_model(spec, uhc_control_params(spec), device=device)
    topo = model.topo
    calls = chip_smoke.capture_substep(model, args.envs, 0)
    R = calls["factor"][0][0][1]
    solves = {a[2].shape[-1]: (a[1], a[2]) for a, _ in calls["solve"]}
    (pa, pk), = calls["pgs"]
    iters = pa[6] if len(pa) > 6 else pk["iters"]
    fns = {
        "ltdl_factor": lambda: ltdl_cuda.factor(topo, R),
        "ltdl_solve[R=55]": lambda: ltdl_cuda.solve(topo, *solves[55]),
        "ltdl_solve[R=1]": lambda: ltdl_cuda.solve(topo, *solves[1]),
        "pgs_solve": lambda: pgs_cuda.pgs_solve(*pa[:6], iters),
    }
    dense = eng.build_model(spec, uhc_control_params(spec), device=device,
                            use_pallas_chol=True)
    dense_calls = chip_smoke.capture_substep(dense, args.envs, 0)
    spd = {a[1].shape[-1]: a[:2] for a, _ in dense_calls["chol"]}
    # K4c: the same systems factored by the plain version
    fac = {nr: (chol.factor(a), b) for nr, (a, b) in spd.items()}
    fns.update({
        "chol_solve_only[R=55]": lambda: chol_cuda.solve_only(*spd[55]),
        "chol_solve_only[R=1]": lambda: chol_cuda.solve_only(*spd[1]),
        "chol_factor_solve[R=55]": lambda: chol_cuda.factor_solve(*spd[55]),
        "chol_apply[R=55]": lambda: chol_cuda.apply(*fac[55]),
        "chol_apply[R=1]": lambda: chol_cuda.apply(*fac[1]),
    })
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()

    def events_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / reps

    def graph_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        return events_ms(g.replay, 3) / reps

    def profiler_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = [e.device_time for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and any(k in e.name for k in ("ltdl_", "pgs_kernel", "chol_"))]
        return float(np.mean(times)) / 1e3 if times else None

    for name, fn in fns.items():
        if not name.startswith(args.only):
            continue
        print(json.dumps(dict(
            name=name, root=root, envs=args.envs,
            wrapper_ms=events_ms(fn, args.reps),
            graph_ms=graph_ms(fn, args.reps),
            profiler_ms=profiler_ms(fn, args.reps), card=smi)), flush=True)


if __name__ == "__main__":
    main()
