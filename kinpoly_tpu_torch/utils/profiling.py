"""Profiling helpers (port of ``kinpoly_tpu/utils/profiling.py``): named
phase timers whose totals go into the training logs, a ``torch.profiler``
trace for TensorBoard, and ``annotate`` to name a span in that trace.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class PhaseTimer:
    """Accumulates wall time per named phase (T_sample, T_update, ... in
    the reference's logs). With ``sync=True`` a phase ends after the
    timer's device has finished its queued work (``torch.cuda.
    synchronize`` on a CUDA device; the CPU runs eagerly), as the JAX
    timer waits on ``jax.effects_barrier``."""

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync: bool = False):
        t0 = time.perf_counter()
        yield
        if sync and self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def summary(self) -> dict:
        return {k: dict(total=v, mean=v / max(self.counts[k], 1))
                for k, v in self.totals.items()}


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a ``torch.profiler`` trace of the block (CPU, and CUDA where
    a device is present) into `log_dir`, readable by TensorBoard's
    profiler plugin and Perfetto."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield


annotate = torch.profiler.record_function
