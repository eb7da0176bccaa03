"""K2's bounds, every right-hand-side width summed, over its profiled device time in the rollout stretch, in percent."""

from harness import readers


def read(run):
    return readers.roofline(run, "ltdl_solve")
