"""Percent of the AR epoch's profiled stretches (context, control steps 4-6, updates) in which no device activity ran."""

from harness import readers


def read(run):
    return readers.device_idle(run)
