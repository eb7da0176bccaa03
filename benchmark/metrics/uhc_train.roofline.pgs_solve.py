"""K3's bound over its profiled device time in the rollout stretch, in percent."""

from harness import readers


def read(run):
    return readers.roofline(run, "pgs_solve")
