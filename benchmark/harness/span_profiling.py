"""Profiled stretches that leave the profiler's user annotations out and
read the port's spans.

``SpanStretch`` is ``profiling.Stretch`` (busy time as the union of the
device activities' intervals, activities, device time per kernel name,
the launch counter ``native.LAUNCHES`` at both ends) with three changes:

- the user annotations (the port's spans, ``Optimizer.step#...``), whose
  CUDA-typed twins span the idle time inside them, are no activities;
- each device activity goes to the innermost span of ``SPAN_GROUPS``
  open on the host when the runtime call that launched it (the same
  correlation id) started, and each group keeps the busy union of its
  activities; an activity under none of them goes to no group;
- the port's host counters (``utils/profiling.COUNTS``: ``fk``, the FK
  calls) are read at both ends;
- with ``host=False`` the profiler records the device's activities and
  the runtime calls alone, not the host's operators: the busy time is the
  same, and stopping the profiler and reading its events take a third of
  the time (no span is attributed, no idle gap named).

It reads the profiler's raw events (``kineto_results.events()``), not
``prof.events()``, whose Python event tree takes ~80 us per event to
build: ~40 s for one AR update's half a million events.
"""

from __future__ import annotations

import bisect
import time
from collections import Counter
from dataclasses import dataclass, field

import torch

from harness.profiling import PROFILER_OWN, Summary, busy_us, idle_gaps

# the spans a stretch attributes device time to, and the layer of each
# (frozen here: a change to the program's own map moves no metric)
SPAN_GROUPS = {
    "ar.kin_policy": "kin_policy",
    "ar.controller": "controller",
    "physics.objects": "objects",
}


@dataclass
class SpanSummary(Summary):
    group_s: Counter = field(default_factory=Counter)   # per (tag, group)
    counts: Counter = field(default_factory=Counter)    # per (tag, counter)


@dataclass
class Event:
    """What a stretch reads of one raw profiler event (times in ns)."""
    name: str
    start: int
    end: int
    corr: int
    device: bool
    annotation: bool


def raw_events(prof) -> list:
    """The raw events of a stopped ``torch.profiler.profile``, the device
    activities' names demangled as ``prof.events()`` gives them."""
    CUDA = torch.autograd.DeviceType.CUDA
    names, out = {}, []
    for e in prof.profiler.kineto_results.events():
        start, device, name = e.start_ns(), e.device_type() == CUDA, e.name()
        if device:
            if name not in names:
                names[name] = torch._C._demangle(name)
            name = names[name]
        out.append(Event(name, start, start + e.duration_ns(),
                         e.correlation_id(), device, e.is_user_annotation()))
    return out


class Innermost:
    """The innermost of (nested) host spans open at each moment."""

    def __init__(self, spans: list):
        marks = sorted([(e.start, 1, -e.end, i) for i, e in enumerate(spans)]
                       + [(e.end, 0, 0, i) for i, e in enumerate(spans)])
        self.starts, self.names, open_ = [], [], []
        for t, is_start, _, i in marks:
            if is_start:
                open_.append(i)
            else:
                open_.remove(i)
            self.starts.append(t)
            self.names.append(spans[open_[-1]].name if open_ else None)

    def at(self, t: float):
        i = bisect.bisect_right(self.starts, t) - 1
        return self.names[i] if i >= 0 else None


def attribute(events: list) -> tuple[list, dict]:
    """(device activities, {group: busy ns}) of a stretch's raw events."""
    dev = [e for e in events if e.device and not e.annotation]
    host = [e for e in events if not e.device]
    inner = Innermost([e for e in host
                       if e.annotation and e.name in SPAN_GROUPS])
    runtime = {e.corr: e for e in host if e.name.startswith("cu")}
    iv = {}
    for k in dev:
        span = inner.at((runtime.get(k.corr) or k).start)
        if span is not None:
            iv.setdefault(SPAN_GROUPS[span], []).append((k.start, k.end))
    return dev, {g: busy_us(x) for g, x in iv.items()}


def gap_labels(events: list, dev: list, n: int = 10) -> list:
    """(label, s) of the n longest idle gaps, from the stretch's first
    event to its last activity: the innermost host op running at the
    gap's middle, under its outermost one (``profiling._host_label``)."""
    if not dev:
        return []
    iv = [(e.start, e.end) for e in dev]
    t0 = min(min(e.start for e in events), min(a for a, _ in iv))
    longest = sorted(idle_gaps(iv, t0, max(b for _, b in iv)),
                     key=lambda g: g[0] - g[1])[:n]
    mids = [(a + b) / 2 for a, b in longest]
    cover = [[] for _ in mids]
    for e in events:
        if e.device or e.annotation or e.name in PROFILER_OWN:
            continue
        for i, t in enumerate(mids):
            if e.start <= t <= e.end:
                cover[i].append(e)
    out = []
    for (a, b), c in zip(longest, cover):
        if not c:
            label = "host: no profiled op"
        else:
            outer = min(c, key=lambda e: e.start)
            inner = max(c, key=lambda e: e.start)
            label = (outer.name if inner is outer
                     else f"{outer.name} > {inner.name}")
        out.append((label, (b - a) / 1e9))
    return out


def _counts():
    from kinpoly_tpu_torch.utils import profiling
    return Counter(profiling.COUNTS)


def _launches():
    from kinpoly_tpu_torch import native
    return Counter(native.LAUNCHES)


class SpanStretch:
    """One profiled stretch: ``start()``, the work, ``stop(tag, steps)``,
    which adds its numbers to `summary` (a ``SpanSummary``) under `tag`
    and returns its busy seconds."""

    def __init__(self, summary: SpanSummary, host: bool = True):
        self.summary, self.host = summary, host
        self.prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.launch0, self.count0 = _launches(), _counts()
        self.prof = profile(activities=[ProfilerActivity.CUDA] + (
            [ProfilerActivity.CPU] if self.host else []))
        self.prof.start()
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()

    def stop(self, tag: str, steps: int = 0) -> float:
        torch.cuda.synchronize()
        wall = time.perf_counter() - self.t0
        self.prof.stop()
        s = self.summary
        for name, c in (_launches() - self.launch0).items():
            s.launches[(tag, name)] += c
        for name, c in (_counts() - self.count0).items():
            s.counts[(tag, name)] += c
        busy = record(s, tag, steps, wall, raw_events(self.prof))
        self.prof = None
        return busy


def record(s: SpanSummary, tag: str, steps: int, wall: float,
           events: list) -> float:
    """Add one stretch's raw events (its `wall` seconds, `steps` control
    steps) to `s` under `tag`; returns its busy seconds."""
    dev, groups = attribute(events)
    s.gaps += gap_labels(events, dev)
    busy = busy_us([(e.start, e.end) for e in dev]) / 1e9
    for g, ns in groups.items():
        s.group_s[(tag, g)] += ns / 1e9
    for e in dev:
        d = (e.end - e.start) / 1e9
        s.kernel_s[(tag, e.name)] += d
        s.op_s[e.name] += d
    s.window_s += wall
    s.busy_s += busy
    s.busy_tag[tag] += busy
    s.activities[tag] += len(dev)
    s.steps[tag] += steps
    return busy
