"""K2's bounds at R = 49 and R = 1 summed over its profiled device time in the AR rollout stretch, in percent."""

from harness import readers


def read(run):
    return readers.roofline(run, "ltdl_solve")
