"""Short profiled stretches of the iteration that follows a run's window,
and what the metric readers take from them.

A stretch runs ``torch.profiler`` (CPU and CUDA activities) between two
synchronisations. Its device activities (kernels, copies, sets) give the
busy time as the union of their intervals (the arithmetic of the port's
``scripts/profile_eval.py``), the activity count, the device time per
kernel name, and the idle gaps with the host operation that was running
in each. The port's launch counter (``native.LAUNCHES``) is read at both
ends, for the launches per kernel and right-hand-side width.
"""

from __future__ import annotations

import time
from collections import Counter
from dataclasses import dataclass, field

import torch


def busy_us(intervals: list) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def idle_gaps(intervals: list, t0: float, t1: float) -> list:
    """The (start, end) gaps in [t0, t1] that no interval covers."""
    gaps, cur = [], t0
    for a, b in sorted(intervals):
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if t1 > cur:
        gaps.append((cur, t1))
    return gaps


@dataclass
class Summary:
    """Sums over every stretch of a run, and per stretch tag."""
    window_s: float = 0.0
    busy_s: float = 0.0
    busy_tag: Counter = field(default_factory=Counter)     # seconds per tag
    activities: Counter = field(default_factory=Counter)   # per tag
    steps: Counter = field(default_factory=Counter)        # per tag
    kernel_s: Counter = field(default_factory=Counter)     # per (tag, name)
    launches: Counter = field(default_factory=Counter)     # per (tag, name)
    op_s: Counter = field(default_factory=Counter)         # per device op
    gaps: list = field(default_factory=list)               # (label, s)

    def breakdown(self, n: int = 10) -> dict:
        return {"device_ops": [[k, v] for k, v in self.op_s.most_common(n)],
                "idle_gaps": [[k, v] for k, v in sorted(
                    self.gaps, key=lambda g: -g[1])[:n]]}


# the profiler's own host events, which say nothing of the program
PROFILER_OWN = ("Activity Buffer Request",)


def _launch_counts():
    from kinpoly_tpu_torch import native
    return Counter(native.LAUNCHES)


class Stretch:
    """One profiled stretch: ``start()``, the work, ``stop(tag, steps)``,
    which adds its numbers to `summary` under `tag`."""

    def __init__(self, summary: Summary):
        self.summary = summary
        self.prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.launch0 = _launch_counts()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()

    def stop(self, tag: str, steps: int = 0) -> None:
        torch.cuda.synchronize()
        wall = time.perf_counter() - self.t0
        self.prof.stop()
        s = self.summary
        for name, c in (_launch_counts() - self.launch0).items():
            s.launches[(tag, name)] += c
        events = self.prof.events()
        dev, host = [], []
        for e in events:
            if e.device_type == torch.autograd.DeviceType.CUDA:
                dev.append(e)
            else:
                host.append(e)
        iv = [(e.time_range.start, e.time_range.end) for e in dev]
        busy = busy_us(iv)
        if iv:
            # the stretch on the trace's own clock: from its first host
            # event to its last activity
            t0 = min(min(e.time_range.start for e in host) if host else iv[0][0],
                     min(a for a, _ in iv))
            t1 = max(b for _, b in iv)
            longest = sorted(idle_gaps(iv, t0, t1), key=lambda g: g[0] - g[1])
            for a, b in longest[:10]:
                s.gaps.append((_host_label(host, (a + b) / 2), (b - a) / 1e6))
        for e in dev:
            d = (e.time_range.end - e.time_range.start) / 1e6
            s.kernel_s[(tag, e.name)] += d
            s.op_s[e.name] += d
        s.window_s += wall
        s.busy_s += busy / 1e6
        s.busy_tag[tag] += busy / 1e6
        s.activities[tag] += len(dev)
        s.steps[tag] += steps
        self.prof = None


def _host_label(host: list, t: float) -> str:
    """The innermost host event running at time t, under its outermost
    one: what the host was doing while the device idled."""
    covering = [e for e in host if e.time_range.start <= t <= e.time_range.end
                and e.name not in PROFILER_OWN]
    if not covering:
        return "host: no profiled op"
    outer = min(covering, key=lambda e: e.time_range.start)
    inner = max(covering, key=lambda e: e.time_range.start)
    return outer.name if inner is outer else f"{outer.name} > {inner.name}"
