"""Where the time of UHC evaluation goes on the card: torch.profiler over a
few control steps of the evaluation loop.

    python -m kinpoly_tpu_torch.scripts.profile_eval --clips 24 --steps 3 \\
        [--trace eval_trace.json]

Prints the host wall time per control step, the device's busy share (union
of kernel intervals over the profiled wall time), kernel launches and
host-device synchronisations per control step, and the kernels and
operators with the most device time. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import time

import torch
from torch.profiler import ProfilerActivity, profile

from kinpoly_tpu_torch.scripts.eval_uhc import build_agent

_SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
               "cudaMemcpy", "cudaMemcpyAsync", "cudaEventSynchronize")


def _busy_us(intervals: list[tuple[float, float]]) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iter", type=int, default=13000)
    p.add_argument("--clips", type=int, default=24)
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--trace", default=None, help="write a chrome trace here")
    args = p.parse_args(argv)

    agent = build_agent(args.iter, args.clips, args.frames, args.seed, "cuda")
    agent.eval_coverage(max_steps=2)                  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        agent.eval_coverage(max_steps=args.steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
    syncs = {n: sum(1 for e in events if e.name == n) for n in _SYNC_CALLS}
    print(f"device: {torch.cuda.get_device_name(0)}")
    print(f"{args.clips} envs, {args.steps} control steps: "
          f"{wall / args.steps * 1e3:.1f} ms per control step (host wall, "
          f"profiler on), device busy {busy / 1e6 / wall:.1%}, "
          f"{len(kernels) / args.steps:.0f} device activities per step")
    print("host-device syncs per step: " + ", ".join(
        f"{n} {c / args.steps:.1f}" for n, c in syncs.items() if c))
    key = "self_device_time_total" if hasattr(
        prof.key_averages()[0], "self_device_time_total") else "self_cuda_time_total"
    print(prof.key_averages().table(sort_by=key, row_limit=25))
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
