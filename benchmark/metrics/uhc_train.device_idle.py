"""Percent of the profiled stretches in which no device activity ran."""

from harness import readers


def read(run):
    return readers.device_idle(run)
