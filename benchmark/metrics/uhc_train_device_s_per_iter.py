"""Seconds of device activity one training iteration takes: the busy time of the profiled iteration's control steps, per step, times the iteration's steps, plus its update's busy time."""

from harness import readers


def read(run):
    return readers.device_s_per_unit(run)
