"""What one run recorded, and the arithmetic the metric readers share.

A run's window is a sequence of whole units of work (training
iterations), each with its start and end on the host's clock and the
samples it completed; one more unit, profiled, follows the window. Traced
runs add spans
(synchronised intervals around calls into a layer, named), per-unit
numbers, and the summary of a profiled stretch.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Unit:
    t0: float
    t1: float
    work: float                 # samples completed
    steps: int = 0              # control steps in it
    profiled: bool = False      # a profiler ran during it
    parts: dict = field(default_factory=dict)   # seconds per phase


@dataclass
class Run:
    config: dict
    traffic: dict
    seconds: float
    trace: bool
    setup_s: float = 0.0
    window_t0: float = 0.0
    units: list = field(default_factory=list)
    profile: object = None                         # profiling.Summary
    counters: dict = field(default_factory=dict)

    def rate(self) -> float | None:
        """Work of all the window's whole units over the time from its
        start to the end of the last one: a stall anywhere in the window
        counts. The profiled unit, run after the window, is not in it."""
        us = self.steady_units()
        if not us:
            return None
        return sum(u.work for u in us) / (us[-1].t1 - self.window_t0)

    def steady_units(self) -> list:
        """The window's units: those no profiler ran in."""
        return [u for u in self.units if not u.profiled]
